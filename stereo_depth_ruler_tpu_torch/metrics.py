"""Structured per-frame metrics, and the per-frame stats computed on the
device.

Port of ``stereo_depth_ruler_tpu/metrics.py``: ``FrameMetrics``,
``frame_metrics`` and ``MetricsLog`` are copies of the JAX package's
(NumPy and the standard library), ``batch_frame_stats`` reduces on the
device in PyTorch. Stage times come from the pipeline's profiler spans
(``pipeline.py``), not from a host-clock timer.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["FrameMetrics", "MetricsLog", "frame_metrics",
           "batch_frame_stats"]


@dataclasses.dataclass
class FrameMetrics:
    frame_index: int
    valid_disparity_frac: float     # fraction of matcher pixels with d >= 0
    depth_coverage: float           # reference's coverage metric
    mean_depth_mm: float
    disparity_mae_vs_ref: Optional[float] = None  # when an oracle is given
    wall_ms: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def frame_metrics(frame_index: int, disp: np.ndarray, depth_z: np.ndarray,
                  skip_cols: int = 0, z_max: float = 12000.0,
                  ref_disp: Optional[np.ndarray] = None,
                  wall_ms: Optional[float] = None) -> FrameMetrics:
    disp = np.asarray(disp)
    z = np.asarray(depth_z)
    valid = disp >= 0
    zsel = z[..., skip_cols:]
    good = np.isfinite(zsel) & (zsel >= 0) & (zsel <= z_max)
    mae = None
    if ref_disp is not None:
        ref_disp = np.asarray(ref_disp)
        both = valid & (ref_disp >= 0)
        both[..., :skip_cols] = False
        if both.any():
            mae = float(np.abs(disp[both] - ref_disp[both]).mean())
    zg = z[np.isfinite(z) & (z > 0) & (z <= z_max)]
    return FrameMetrics(
        frame_index=frame_index,
        valid_disparity_frac=float(valid.mean()),
        depth_coverage=float(good.sum()) / float(z.size),
        mean_depth_mm=float(zg.mean()) if zg.size else float("nan"),
        disparity_mae_vs_ref=mae,
        wall_ms=wall_ms,
    )


def batch_frame_stats(disp: torch.Tensor, z: torch.Tensor,
                      skip_cols: int = 0,
                      z_max: float = 12000.0) -> torch.Tensor:
    """(..., H, W) disparity + depth -> (..., 3) float32
    [valid_frac, depth_coverage, mean_depth_mm], reduced on the device so
    a caller fetches 12 bytes per frame instead of the maps.

    valid_frac counts d >= 0; depth_coverage counts finite 0 <= z <= z_max
    right of ``skip_cols`` over all pixels; the mean depth takes finite
    0 < z <= z_max (NaN where there is none).

    The two fractions are counts times the float32 reciprocal of the pixel
    count, as the JAX package's jitted function computes them (XLA turns a
    division by a constant into that product): a true division differs
    from it by an ulp for some counts."""
    dims = (-2, -1)
    inv = float(np.float32(1) / np.float32(z.shape[-2] * z.shape[-1]))
    vfrac = (disp >= 0).sum(dim=dims).to(torch.float32) * inv
    zs = z[..., skip_cols:]
    good = torch.isfinite(zs) & (zs >= 0) & (zs <= z_max)
    cov = good.sum(dim=dims).to(torch.float32) * inv
    zok = torch.isfinite(z) & (z > 0) & (z <= z_max)
    zsum = torch.where(zok, z, torch.zeros_like(z)).sum(dim=dims)
    zcnt = zok.sum(dim=dims)
    meanz = torch.where(zcnt > 0, zsum / zcnt.clamp(min=1),
                        torch.full_like(zsum, float("nan")))
    return torch.stack([vfrac, cov, meanz], dim=-1)


class MetricsLog:
    """Append-only JSONL metrics sink + summary aggregation."""

    def __init__(self, path=None):
        self.path = Path(path) if path else None
        self.records: List[FrameMetrics] = []

    def append(self, m: FrameMetrics) -> None:
        self.records.append(m)
        if self.path:
            with open(self.path, "a") as f:
                f.write(m.to_json() + "\n")

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        out = {
            "frames": len(self.records),
            "valid_disparity_frac": float(np.mean(
                [m.valid_disparity_frac for m in self.records])),
            "depth_coverage": float(np.mean(
                [m.depth_coverage for m in self.records])),
        }
        walls = [m.wall_ms for m in self.records if m.wall_ms is not None]
        if walls:
            out["mean_wall_ms"] = float(np.mean(walls))
            out["fps"] = 1000.0 / float(np.mean(walls))
        maes = [m.disparity_mae_vs_ref for m in self.records
                if m.disparity_mae_vs_ref is not None]
        if maes:
            out["disparity_mae_vs_ref"] = float(np.mean(maes))
        return out
