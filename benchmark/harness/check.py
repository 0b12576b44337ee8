"""The comparison that decides ``correct``: the program's outputs against the
plain reference's, number by number, each against its limit.

``judge`` holds any driver's numbers against the configuration's
``limits``. The rest is the stereo pipeline's (drivers/pipeline.py):
its numbers, each the worst over the checked frames:

- ``rect_gap``: the largest gap of the rectified eyes, in gray levels
  (gray conversion and rectification);
- ``conf_diff_pct``: the share of pixels whose LR confidence differs, in %
  (both matchers: the confidence is 1 only where the left disparity is
  valid and the right one agrees with it);
- ``disp_diff_pct``: the share of pixels whose filtered disparity differs
  by more than ``DISP_TOL`` px or is valid on one side only, in %
  (downscale, matchers, WLS);
- ``xyz_diff_pct``: the share of pixels whose XYZ point lies further than
  ``XYZ_TOL`` of the reference point's norm from it, or is finite on one
  side only, in % (reprojection);
- ``stats_gap``: the largest relative gap of a frame's stats, over every
  frame of a checked pair that the window fetched (the frame stats).

A frame missing from the window's results fails the run as ``failed``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

DISP_TOL = 0.01      # px: float32 rounding in the WLS ratio is ~1e-4 px
XYZ_TOL = 2e-3       # of |xyz|: DISP_TOL at a 5 px disparity
NAMES = ("rect_gap", "conf_diff_pct", "disp_diff_pct", "xyz_diff_pct",
         "stats_gap")


def _pct(mask: torch.Tensor) -> float:
    return 100.0 * float(mask.float().mean())


def frame_numbers(got: Dict[str, torch.Tensor],
                  want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The first four numbers for one frame: ``got`` and ``want`` map each
    output name to that frame's tensor, on one device."""
    rect = max(float(torch.nan_to_num((got[k].float() - want[k]).abs(),
                                      nan=float("inf")).max())
               for k in ("left_rectified", "right_rectified"))
    conf = _pct(got["confidence"].float() != want["confidence"])
    dg, dw = got["disparity"].float(), want["disparity"]
    dbad = ((dg >= 0) != (dw >= 0)) | (((dg - dw).abs() > DISP_TOL)
                                       & (dw >= 0))
    xg, xw = got["xyz"].float(), want["xyz"]
    fin_g, fin_w = torch.isfinite(xg).all(-3), torch.isfinite(xw).all(-3)
    both = fin_g & fin_w
    diff = torch.where(both.unsqueeze(-3), xg - xw, torch.zeros_like(xg))
    norm = torch.where(both.unsqueeze(-3), xw, torch.zeros_like(xw))
    far = diff.norm(dim=-3) > XYZ_TOL * norm.norm(dim=-3)
    xbad = (fin_g != fin_w) | (both & far)
    return {"rect_gap": rect, "conf_diff_pct": conf,
            "disp_diff_pct": _pct(dbad), "xyz_diff_pct": _pct(xbad)}


def stats_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest relative gap between two (..., 3) stats arrays, at most
    1: a stat that is NaN (no valid depth) on one side only is wholly lost,
    a gap of 1; NaN on both sides is none."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    gap = np.where(np.isnan(got) & np.isnan(want), 0.0,
                   np.where(np.isnan(gap), 1.0, np.minimum(gap, 1.0)))
    return float(gap.max()) if gap.size else 0.0


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}} in the
    limits' order): the numbers a driver gives against the configuration's
    ``limits``. Both must name the same numbers; a number without a limit,
    or a limit without a number, raises ValueError naming it."""
    extra, lacking = set(numbers) - set(limits), set(limits) - set(numbers)
    if extra or lacking:
        raise ValueError(f"numbers without a limit: {sorted(extra)}; "
                         f"limits without a number: {sorted(lacking)}")
    table = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def compare(held: List[Tuple[int, Dict[str, torch.Tensor]]],
            fetched: List[Tuple[int, np.ndarray]],
            ref: Dict[int, Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Every number: ``held`` is (pool pair, that frame's outputs) for the
    frames whose outputs were kept, ``fetched`` (pool pair, stats) for
    every frame of a checked pair, ``ref`` the reference's outputs by pool
    pair."""
    out = dict.fromkeys(NAMES, 0.0)
    for pair, got in held:
        want = {k: v.to(got["disparity"].device) for k, v in ref[pair].items()}
        for k, v in frame_numbers(got, want).items():
            out[k] = max(out[k], v)
    for pair, stats in fetched:
        out["stats_gap"] = max(out["stats_gap"], stats_gap(
            stats, ref[pair]["frame_stats"].cpu().numpy()))
    return out
