"""Disparity -> metric 3D reprojection via the calibration Q matrix.

Port of ``stereo_depth_ruler_tpu/ops/reproject.py`` (cv::reprojectImageTo3D
semantics): plain torch, a few multiply-adds per pixel, no kernel.
``quirk_compat=True`` replicates the reference's full-resolution Q applied
to a half-resolution disparity; the default scales Q geometrically.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["scale_q", "reproject_to_3d", "depth_from_disparity"]


def scale_q(Q: np.ndarray, scale: float) -> np.ndarray:
    """Q for a disparity map computed at ``scale`` x the calibration
    resolution: Q' = Q @ diag(1/s, 1/s, 1/s, 1). NumPy copy of
    ``stereo_depth_ruler_tpu/ops/reproject.py:scale_q``."""
    Q = np.asarray(Q, np.float64)
    S = np.diag([1.0 / scale, 1.0 / scale, 1.0 / scale, 1.0])
    return Q @ S


def reproject_to_3d(disp: torch.Tensor, Q, scale: float = 1.0,
                    quirk_compat: bool = False,
                    handle_missing: bool = False,
                    missing_z: float = 10000.0,
                    row_offset=0, col_offset=0,
                    layout: str = "hwc") -> torch.Tensor:
    """(..., H, W) disparity -> (..., H, W, 3) XYZ (``layout='hwc'``) or
    (..., 3, H, W) (``layout='chw'``) in calibration units.

    [X Y Z W]^T = Q [x y d 1]^T, output XYZ/W. Invalid disparities
    (d <= 0) give inf, or Z = ``missing_z`` with ``handle_missing``.
    ``row_offset``/``col_offset`` are the global pixel coordinates of a
    tile's first row and column."""
    if layout not in ("hwc", "chw"):
        raise ValueError(f"layout must be 'hwc' or 'chw', got {layout!r}")
    Q = np.asarray(Q, np.float64)
    if scale != 1.0 and not quirk_compat:
        Q = scale_q(Q, scale)
    q = [[float(v) for v in np.float32(row)] for row in Q]
    h, w = disp.shape[-2], disp.shape[-1]
    dev = disp.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + col_offset
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + row_offset
    d = disp.to(torch.float32)

    def homo(r):
        return q[r][0] * xs + q[r][1] * ys + q[r][2] * d + q[r][3]

    X, Y, Z, Wh = homo(0), homo(1), homo(2), homo(3)
    Wsafe = torch.where(Wh.abs() < 1e-12, torch.full_like(Wh, 1e-12), Wh)
    axis = -1 if layout == "hwc" else -3
    if handle_missing:
        Z = torch.where(d <= 0, torch.full_like(Z, missing_z), Z / Wsafe)
        xyz = torch.stack([X / Wsafe, Y / Wsafe, Z], dim=axis)
    else:
        xyz = torch.stack([X / Wsafe, Y / Wsafe, Z / Wsafe], dim=axis)
        invalid = (d <= 0).unsqueeze(axis)
        xyz = torch.where(invalid, torch.full_like(xyz, float("inf")), xyz)
    return xyz


def depth_from_disparity(disp: torch.Tensor, Q, scale: float = 1.0,
                         quirk_compat: bool = False) -> torch.Tensor:
    """Z channel only."""
    return reproject_to_3d(disp, Q, scale=scale,
                           quirk_compat=quirk_compat)[..., 2]
