"""The SGBM matcher on five hand-written CUDA kernels (``ops/csrc``).

Counterpart of ``stereo_depth_ruler_tpu/ops/sgbm_pallas.py:sgbm_pallas``:
Sobel in plain torch, then

- K1 ``cost_volume``  (csrc/cost_box.cu): BT cost + box sum -> int16 C;
- K2 ``sgm_pass``     (csrc/sgm_pass.cu): one launch per path direction,
  adding L into an int32 S (the 8-path sum reaches ~70000, past int16);
- K3 ``wta_lr``       (csrc/wta_lr.cu): WTA, uniqueness, subpixel, LR;
- K4 ``speckle_labels`` (csrc/speckle.cu): union-find CCL -> int32 labels;
- K5 ``speckle_keep``   (csrc/speckle.cu): label histogram -> the
  disparity without the components of at most speckle_window_size pixels.

Volumes are ``(B, H, W, D)`` with D contiguous. Each wrapper dispatches on
the device of its input: a CPU tensor gets the plain version of
``ops/sgbm.py``; a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches per wrapper; nothing else touches it.
"""

from __future__ import annotations

import torch

from .sgbm_ref import SGBMParams

from ..utils import kernels
from . import sgbm as plain

__all__ = ["LAUNCHES", "reset_launch_counts", "cost_volume", "sgm_pass",
           "aggregate", "wta_lr", "speckle_labels", "speckle_keep",
           "sgbm_cuda"]

LAUNCHES = {"cost_box": 0, "sgm_pass": 0, "wta_lr": 0, "speckle_labels": 0,
            "speckle_keep": 0}


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


def speckle_labels(disp: torch.Tensor, max_diff: float,
                   max_iters: int = 0) -> torch.Tensor:
    """(B, H, W) float32 disparity (invalid < 0) -> (B, H, W) int32
    component labels: the smallest flat index of each 4-connected
    component of valid pixels whose disparities differ by at most
    ``max_diff``, H*W for an invalid pixel. The kernel's union-find always
    runs to the end, so on CUDA only ``max_iters == 0`` is accepted."""
    if not _on_cuda(disp):
        return plain.speckle_labels(disp, max_diff, max_iters)
    if max_iters != 0:
        raise ValueError("the labels kernel has no capped mode: "
                         f"max_iters must be 0, got {max_iters}")
    _require(disp, torch.float32, 3, "disp")
    B, H, W = disp.shape
    out = torch.empty((B, H, W), dtype=torch.int32, device=disp.device)
    rc = kernels.load().sdr_speckle_labels(disp.data_ptr(), out.data_ptr(),
                                           B, H, W, float(max_diff),
                                           _stream())
    kernels.check(rc, "speckle_labels")
    LAUNCHES["speckle_labels"] += 1
    return out


def speckle_keep(disp: torch.Tensor, labels: torch.Tensor,
                 max_size: int) -> torch.Tensor:
    """(B, H, W) disparity and its labels -> the disparity where the
    pixel's component has more than ``max_size`` pixels, else -1.0."""
    if not _on_cuda(disp, labels):
        return plain.speckle_keep(disp, labels, max_size)
    _require(disp, torch.float32, 3, "disp")
    _require(labels, torch.int32, 3, "labels")
    if disp.shape != labels.shape:
        raise ValueError(f"shape mismatch {tuple(disp.shape)} "
                         f"{tuple(labels.shape)}")
    B, H, W = disp.shape
    sizes = torch.empty((B, H * W + 1), dtype=torch.int32, device=disp.device)
    out = torch.empty_like(disp)
    rc = kernels.load().sdr_speckle_keep(disp.data_ptr(), labels.data_ptr(),
                                         sizes.data_ptr(), out.data_ptr(),
                                         B, H, W, int(max_size), _stream())
    kernels.check(rc, "speckle_keep")
    LAUNCHES["speckle_keep"] += 1
    return out


def sgbm_cuda(left: torch.Tensor, right: torch.Tensor,
              params: SGBMParams = SGBMParams(),
              apply_lr: bool = True) -> torch.Tensor:
    """(B, H, W) float32 pair -> (B, H, W) float32 disparity, invalid -1.0:
    WTA and the LR check, then the speckle filter when
    ``speckle_window_size > 0``."""
    _check_params(params)
    if left.dim() != 3 or left.shape != right.shape:
        raise ValueError(f"need two (B, H, W) images of one shape, got "
                         f"{tuple(left.shape)} {tuple(right.shape)}")
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(left, cap).contiguous()
    rt = plain.sobel_clip(right, cap).contiguous()
    C = cost_volume(lt, rt, params)
    S = aggregate(C, params)
    disp = wta_lr(S, params, apply_lr)
    del C, S
    if params.speckle_window_size > 0:
        labels = speckle_labels(disp, params.speckle_range)
        disp = speckle_keep(disp, labels, params.speckle_window_size)
    return disp
