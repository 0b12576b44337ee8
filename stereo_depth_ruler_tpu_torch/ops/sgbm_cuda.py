"""The SGBM matcher on three hand-written CUDA kernels (``ops/csrc``).

Counterpart of ``stereo_depth_ruler_tpu/ops/sgbm_pallas.py:sgbm_pallas``:
Sobel in plain torch, then

- K1 ``cost_volume``  (csrc/cost_box.cu): BT cost + box sum -> int16 C;
- K2 ``sgm_pass``     (csrc/sgm_pass.cu): one launch per path direction,
  adding L into an int32 S (the 8-path sum reaches ~70000, past int16);
- K3 ``wta_lr``       (csrc/wta_lr.cu): WTA, uniqueness, subpixel, LR.

Volumes are ``(B, H, W, D)`` with D contiguous. Each wrapper dispatches on
the device of its input: a CPU tensor gets the plain version of
``ops/sgbm.py``; a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches per wrapper; nothing else touches it.
"""

from __future__ import annotations

import torch

from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams

from ..utils import kernels
from . import sgbm as plain

__all__ = ["LAUNCHES", "reset_launch_counts", "cost_volume", "sgm_pass",
           "aggregate", "wta_lr", "sgbm_cuda"]

LAUNCHES = {"cost_box": 0, "sgm_pass": 0, "wta_lr": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else
    or on a mix."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, "
                         f"got {sorted(kinds)}")
    return kinds == {"cuda"}


def _require(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_params(params: SGBMParams) -> None:
    if params.min_disparity < 0:
        raise ValueError("min_disparity < 0 is not supported "
                         "(the TPU kernel asserts the same)")
    if params.num_disparities % 16 or not 16 <= params.num_disparities <= 256:
        raise ValueError("num_disparities must be a multiple of 16 in "
                         f"[16, 256], got {params.num_disparities}")


def cost_volume(lt: torch.Tensor, rt: torch.Tensor,
                params: SGBMParams) -> torch.Tensor:
    """(B, H, W) Sobel-clipped images -> (B, H, W, D) int16 boxed BT cost."""
    if not _on_cuda(lt, rt):
        return plain.cost_volume(lt, rt, params).to(torch.int16)
    _require(lt, torch.float32, 3, "lt")
    _require(rt, torch.float32, 3, "rt")
    if lt.shape != rt.shape:
        raise ValueError(f"shape mismatch {tuple(lt.shape)} {tuple(rt.shape)}")
    B, H, W = lt.shape
    D = params.num_disparities
    out = torch.empty((B, H, W, D), dtype=torch.int16, device=lt.device)
    rc = kernels.load().sdr_cost_box(lt.data_ptr(), rt.data_ptr(),
                                     out.data_ptr(), B, H, W, D,
                                     params.min_disparity, params.block_size,
                                     _stream())
    kernels.check(rc, "cost_box")
    LAUNCHES["cost_box"] += 1
    return out


def sgm_pass(C: torch.Tensor, S: torch.Tensor, dy: int, dx: int,
             P1: int, P2: int, accumulate: bool) -> None:
    """One path direction over C (B, H, W, D) int16, written into the int32
    S in place: S = L, or S += L with ``accumulate``."""
    if not _on_cuda(C, S):
        L = plain.directional_pass(C.to(torch.float32), dy, dx,
                                   float(P1), float(P2)).to(torch.int32)
        if accumulate:
            S += L
        else:
            S.copy_(L)
        return
    _require(C, torch.int16, 4, "C")
    _require(S, torch.int32, 4, "S")
    if C.shape != S.shape:
        raise ValueError(f"shape mismatch {tuple(C.shape)} {tuple(S.shape)}")
    B, H, W, D = C.shape
    rc = kernels.load().sdr_sgm_pass(C.data_ptr(), S.data_ptr(), B, H, W, D,
                                     dy, dx, int(P1), int(P2),
                                     int(accumulate), _stream())
    kernels.check(rc, "sgm_pass")
    LAUNCHES["sgm_pass"] += 1


def aggregate(C: torch.Tensor, params: SGBMParams) -> torch.Tensor:
    """Sum of the ``params.num_paths`` directional passes, (B, H, W, D)
    int32."""
    S = torch.empty(C.shape, dtype=torch.int32, device=C.device)
    for i, (dy, dx) in enumerate(params.path_dirs):
        sgm_pass(C, S, dy, dx, params.P1, params.P2, accumulate=i > 0)
    return S


def wta_lr(S: torch.Tensor, params: SGBMParams,
           apply_lr: bool = True) -> torch.Tensor:
    """(B, H, W, D) int32 path sums -> (B, H, W) float32 disparity, -1.0
    where invalid (uniqueness, no partner column, LR check)."""
    if not _on_cuda(S):
        return plain.wta_lr(S.to(torch.float32), params, apply_lr)
    _require(S, torch.int32, 4, "S")
    B, H, W, D = S.shape
    out = torch.empty((B, H, W), dtype=torch.float32, device=S.device)
    rc = kernels.load().sdr_wta_lr(
        S.data_ptr(), out.data_ptr(), B, H, W, D, params.min_disparity,
        params.uniqueness_ratio, int(params.quantize_16),
        params.disp12_max_diff, int(apply_lr), _stream())
    kernels.check(rc, "wta_lr")
    LAUNCHES["wta_lr"] += 1
    return out


def sgbm_cuda(left: torch.Tensor, right: torch.Tensor,
              params: SGBMParams = SGBMParams(),
              apply_lr: bool = True) -> torch.Tensor:
    """(B, H, W) float32 pair -> (B, H, W) float32 disparity, invalid -1.0.

    The speckle filter is not ported yet, so a ``params`` with
    ``speckle_window_size > 0`` raises NotImplementedError."""
    if params.speckle_window_size > 0:
        raise NotImplementedError(plain.SPECKLE_QUEUED)
    _check_params(params)
    if left.dim() != 3 or left.shape != right.shape:
        raise ValueError(f"need two (B, H, W) images of one shape, got "
                         f"{tuple(left.shape)} {tuple(right.shape)}")
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(left, cap).contiguous()
    rt = plain.sobel_clip(right, cap).contiguous()
    C = cost_volume(lt, rt, params)
    S = aggregate(C, params)
    return wta_lr(S, params, apply_lr)
