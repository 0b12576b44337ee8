# Frozen copy of stereo_depth_ruler_tpu_torch/ops/reproject.py (reproject_to_3d, scale_q) and metrics.py (batch_frame_stats), with a dtype argument.
"""Reprojection of a disparity map to metric 3D points (cv::
reprojectImageTo3D with the rig's Q, scaled to the matcher's resolution)
and the per-frame stats, in plain PyTorch."""

from __future__ import annotations

import numpy as np
import torch


def reproject(disp: torch.Tensor, Q: np.ndarray, scale: float
              ) -> torch.Tensor:
    """(..., H, W) disparity -> (..., 3, H, W) XYZ, inf where d <= 0. Q is
    scaled by diag(1/s, 1/s, 1/s, 1) for a map at ``scale`` x the rig's
    resolution. Computed in the dtype of ``disp``."""
    Q = np.asarray(Q, np.float64)
    if scale != 1.0:
        Q = Q @ np.diag([1.0 / scale, 1.0 / scale, 1.0 / scale, 1.0])
    q = [[float(v) for v in np.float32(row)] for row in Q]
    h, w = disp.shape[-2], disp.shape[-1]
    dt, dev = disp.dtype, disp.device
    xs = torch.arange(w, dtype=dt, device=dev)[None, :]
    ys = torch.arange(h, dtype=dt, device=dev)[:, None]

    def homo(r):
        return q[r][0] * xs + q[r][1] * ys + q[r][2] * disp + q[r][3]

    X, Y, Z, Wh = homo(0), homo(1), homo(2), homo(3)
    Wsafe = torch.where(Wh.abs() < 1e-12, torch.full_like(Wh, 1e-12), Wh)
    xyz = torch.stack([X / Wsafe, Y / Wsafe, Z / Wsafe], dim=-3)
    return torch.where((disp <= 0).unsqueeze(-3),
                       torch.full_like(xyz, float("inf")), xyz)


def frame_stats(disp: torch.Tensor, z: torch.Tensor, skip_cols: int,
                z_max: float) -> torch.Tensor:
    """(..., 3) [share of d >= 0, share of finite 0 <= z <= z_max right of
    ``skip_cols`` over all pixels, mean of finite 0 < z <= z_max]. The
    shares are counts times the float32 reciprocal of the pixel count."""
    dims = (-2, -1)
    inv = float(np.float32(1) / np.float32(z.shape[-2] * z.shape[-1]))
    vfrac = (disp >= 0).sum(dim=dims).to(z.dtype) * inv
    zs = z[..., skip_cols:]
    good = torch.isfinite(zs) & (zs >= 0) & (zs <= z_max)
    cov = good.sum(dim=dims).to(z.dtype) * inv
    zok = torch.isfinite(z) & (z > 0) & (z <= z_max)
    zsum = torch.where(zok, z, torch.zeros_like(z)).sum(dim=dims)
    zcnt = zok.sum(dim=dims)
    meanz = torch.where(zcnt > 0, zsum / zcnt.clamp(min=1),
                        torch.full_like(zsum, float("nan")))
    return torch.stack([vfrac, cov, meanz], dim=-1)
