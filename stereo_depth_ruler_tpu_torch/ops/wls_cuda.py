"""The WLS disparity filter on two hand-written CUDA kernels (``ops/csrc``).

Counterpart of ``stereo_depth_ruler_tpu/ops/wls_pallas.py:
wls_disparity_filter_pallas``:

- K7 ``shift_gather_conf`` (csrc/shift_gather.cu): the right view's
  disparity at x - round(dl), the LR confidence, and the stacked
  right-hand sides (conf·max(dl, 0), conf), in one pass;
- K6 ``fgs_pass`` (csrc/fgs_pass.cu): one FGS sweep, rows or columns, of
  both right-hand sides: the Thomas solve from both ends of each line, a
  thread per half line that runs only the recurrence, fed by producer
  warps that stage the guide and the right-hand sides and compute the
  weights ahead of it. Six launches per filter (3 iterations x 2 axes).

Each wrapper dispatches on the device of its input: a CPU tensor gets the
plain version of ``ops/wls.py``; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per wrapper; ``FGS_PLANS``
counts K6's launches by the lines a block its entry reports it took: 8,
or 4 in a row pass whose rows would leave multiprocessors without a
block of 8.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils import kernels
from . import wls as plain

__all__ = ["LAUNCHES", "reset_launch_counts", "FGS_PLANS",
           "reset_fgs_plans", "shift_gather_conf", "fgs_pass",
           "fgs_filter_cuda", "wls_disparity_filter_cuda"]

LAUNCHES = {"shift_gather": 0, "fgs_pass": 0}
# K6's launch plans, by the lines a block csrc/fgs_pass.cu reports
FGS_PLANS = {"lines8": 0, "lines4": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_fgs_plans() -> None:
    for k in FGS_PLANS:
        FGS_PLANS[k] = 0


def shift_gather_conf(disp_left: torch.Tensor, disp_right: torch.Tensor,
                      max_disp: int, lrc_thresh: float = 24.0 / 16.0
                      ) -> torch.Tensor:
    """(B, H, W) left/right disparities -> (B, 2, H, W) float32 right-hand
    sides (conf·max(dl, 0), conf); see ``ops/wls.py:shift_gather_conf``."""
    if not kernels.on_cuda(disp_left, disp_right):
        return plain.shift_gather_conf(disp_left, disp_right, max_disp,
                                       lrc_thresh)
    kernels.require(disp_left, torch.float32, 3, "disp_left")
    kernels.require(disp_right, torch.float32, 3, "disp_right")
    if disp_left.shape != disp_right.shape:
        raise ValueError(f"shape mismatch {tuple(disp_left.shape)} "
                         f"{tuple(disp_right.shape)}")
    B, H, W = disp_left.shape
    rhs = torch.empty((B, 2, H, W), dtype=torch.float32,
                      device=disp_left.device)
    rc = kernels.load().sdr_shift_gather_conf(
        disp_left.data_ptr(), disp_right.data_ptr(), rhs.data_ptr(), B, H, W,
        int(max_disp), float(lrc_thresh), float(plain.GATHER_FILL),
        kernels.stream())
    kernels.check(rc, "shift_gather")
    LAUNCHES["shift_gather"] += 1
    return rhs


def fgs_pass(u: torch.Tensor, guide: torch.Tensor, lam: float, sigma: float,
             axis: int) -> torch.Tensor:
    """One FGS sweep of the (B, 2, H, W) right-hand sides under the
    (B, H, W) guide, along rows (axis -1) or columns (axis -2)."""
    if not kernels.on_cuda(u, guide):
        return plain.fgs_pass(u, guide, lam, sigma, axis)
    kernels.require(u, torch.float32, 4, "u")
    kernels.require(guide, torch.float32, 3, "guide")
    B, R, H, W = u.shape
    if R != 2 or guide.shape != (B, H, W):
        raise ValueError(f"need (B, 2, H, W) right-hand sides and a (B, H, W) "
                         f"guide, got {tuple(u.shape)} {tuple(guide.shape)}")
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    out = torch.empty_like(u)
    cp = torch.empty_like(guide)   # the elimination's c' and a''
    plan = ctypes.c_int(0)
    rc = kernels.load().sdr_fgs_pass(guide.data_ptr(), u.data_ptr(),
                                     out.data_ptr(), cp.data_ptr(), B, H, W,
                                     int(axis == -1), float(lam),
                                     float(sigma), ctypes.addressof(plan),
                                     kernels.stream())
    kernels.check(rc, "fgs_pass")
    LAUNCHES["fgs_pass"] += 1
    FGS_PLANS[f"lines{plan.value}"] += 1
    return out


def fgs_filter_cuda(u: torch.Tensor, guide: torch.Tensor,
                    **kwargs) -> torch.Tensor:
    """``ops/wls.py:fgs_filter`` of (B, 2, H, W) right-hand sides, one
    ``fgs_pass`` launch per iteration and axis."""
    return plain.fgs_filter(u, guide, sweep=fgs_pass, **kwargs)


def wls_disparity_filter_cuda(disp_left: torch.Tensor,
                              disp_right: torch.Tensor, guide: torch.Tensor,
                              **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops/wls.py:wls_disparity_filter`` of (B, H, W) disparities on the
    kernels -> (filtered, confidence); the same keyword arguments."""
    return plain.wls_disparity_filter(disp_left, disp_right, guide,
                                      gather=shift_gather_conf,
                                      sweep=fgs_pass, **kwargs)
