"""Per-frame stats computed on the device.

Port of ``stereo_depth_ruler_tpu/metrics.py:batch_frame_stats``.
"""

from __future__ import annotations

import torch

__all__ = ["batch_frame_stats"]


def batch_frame_stats(disp: torch.Tensor, z: torch.Tensor,
                      skip_cols: int = 0,
                      z_max: float = 12000.0) -> torch.Tensor:
    """(..., H, W) disparity + depth -> (..., 3) float32
    [valid_frac, depth_coverage, mean_depth_mm], reduced on the device so
    a caller fetches 12 bytes per frame instead of the maps.

    valid_frac counts d >= 0; depth_coverage counts finite 0 <= z <= z_max
    right of ``skip_cols`` over all pixels; the mean depth takes finite
    0 < z <= z_max (NaN where there is none)."""
    dims = (-2, -1)
    vfrac = (disp >= 0).to(torch.float32).mean(dim=dims)
    zs = z[..., skip_cols:]
    good = torch.isfinite(zs) & (zs >= 0) & (zs <= z_max)
    cov = good.sum(dim=dims).to(torch.float32) / (z.shape[-2] * z.shape[-1])
    zok = torch.isfinite(z) & (z > 0) & (z <= z_max)
    zsum = torch.where(zok, z, torch.zeros_like(z)).sum(dim=dims)
    zcnt = zok.sum(dim=dims)
    meanz = torch.where(zcnt > 0, zsum / zcnt.clamp(min=1),
                        torch.full_like(zsum, float("nan")))
    return torch.stack([vfrac, cov, meanz], dim=-1)
