"""The SGBM matcher on hand-written CUDA kernels (``ops/csrc``).

Counterpart of ``stereo_depth_ruler_tpu/ops/sgbm_pallas.py:sgbm_pallas``
and, for the shared-cost pair, of ``sgbm_pair_pallas``: Sobel in plain
torch, then

- K1 ``cost_volume``  (csrc/cost_box.cu): BT cost + box sum -> int16 C;
  ``cost_volume_pair``, its pair mode, writes the left and the right
  matcher's volumes in one launch;
- the aggregation, WTA and LR check (``aggregate_wta``), on the route
  ``agg_route`` picks from the parameters and the width alone, before any
  launch, as ``sgbm_pallas`` picks its branch (``fused_wta``, as there):
  - the batch sweeps (csrc/tile_sgm.cu), the JAX main path's
    ``_fused_aggregate_wta`` with a bias, where ``fused_wta``, 4 or 8
    paths and ``tile_bias`` gives one, on frames no wider than the sweeps
    take on the card (``sweep_max_width``): ``agg_down`` (the down-going
    paths into an int16 S_dh = L_down - bias), ``agg_horiz`` (both
    horizontal paths added into it) and ``agg_up_wta`` (the up-going paths
    fused with the WTA, then the LR pass), over the whole batch; the
    8-path sum never reaches device memory;
  - otherwise (8 paths at block 7, whose S_dh passes the biased int16
    range, fewer than 4 paths, ``fused_wta=False``, a D the sweeps do not
    take, or a wider frame) K2 ``sgm_pass`` (csrc/sgm_pass.cu), one launch
    per path direction adding L into an int32 S, and K3 ``wta_lr``
    (csrc/wta_lr.cu): WTA, uniqueness, subpixel, LR;
  ``mirror_from`` puts the trailing frames, the right matcher's, in the
  mirror mode of either route;
- K4 ``speckle_labels`` (csrc/speckle.cu): union-find CCL -> int32 labels;
- K5 ``speckle_keep``   (csrc/speckle.cu): label histogram -> the
  disparity without the components of at most speckle_window_size pixels.

Beside the matcher, the speckle functions of the JAX package that run
rounds of segmented sweeps, on the sweep kernel (csrc/sweep.cu):
``sweep_labels`` (its labels mode; ``speckle_labels`` with ``max_iters``
> 0 runs it) and ``propagate_keep`` (its propagate mode), with the
compositions ``speckle_keep_seeded`` and ``speckle_filter`` on top, which
also use the sort kernels of ``ops/sort_cuda.py``.

The staged chain (``sgbm_staged_cuda``, the counterpart of the JAX
package's cost + down, directional passes and ``wta_lr_pallas`` chain)
runs the same matcher on int16 partial path sums:

- ``cost_down`` (csrc/cost_down.cu): C and the down-going sum in one
  kernel;
- ``sgm_pass`` with an int16 S (csrc/sgm_pass.cu, counted as
  ``sgm_pass_i16``; ``aggregate_i16`` sums a set of directions): the
  horizontal and the up-going sums;
- ``wta_lr3`` (csrc/wta_lr.cu): K3's body on the sum of the three.

``transpose_vol``, ``transpose_leading`` and ``transpose_dhw_to_wdh``
(csrc/transpose.cu) are the JAX package's three volume transposes; the
port's layout needs none of them, the stage profiler times them.

``sgbm_tile_cuda`` (K9, the JAX package's ``sgbm_tile_pallas``) is the
per-tile matcher of the sharded path, on a row slab of the cost volume with
halo rows, which K1 builds (``parallel/sharded.py``). ``tile_bias`` picks
its route as the JAX package's ``_wta_bias`` does: where the down-going and
horizontal paths' sum fits int16 as it is or shifted by a bias, the
batch route's three sweeps on the slab as a batch of one frame
(``agg_down`` with the top halo, ``agg_horiz`` and ``agg_up_wta`` of the
tile's own rows, with its LR pass), on one int16 volume S_dh; otherwise K2
x8 and K3 on an int32 S.

Volumes are ``(B, H, W, D)`` with D contiguous. Each wrapper dispatches on
the device of its input: a CPU tensor gets the plain version of
``ops/sgbm.py``; a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches per wrapper and mode (``cost_box_pair``,
``wta_lr_mirror`` and ``agg_up_wta_mirror`` are the pair modes,
``sweep_labels`` and ``sweep_propagate`` the sweep kernel's two,
``sgm_pass_i16`` K2 on an int16 S, ``sgbm_tile`` the tile matchers,
``agg_down``, ``agg_horiz``, ``agg_up_wta`` and ``agg_lr`` tile_sgm.cu's
kernels, on the matcher's batch and on K9's slabs); nothing else touches
it. ``UP_WTA_PLANS`` counts the launches of the up sweep with the WTA
(``agg_up_wta`` and its mirror mode) by the launch plan
csrc/tile_sgm.cu reports it ran: "ring" (WTA warps of their own, fed
through a ring of row slots) or "inline" (the WTA on the path warps);
``sweep_plan`` gives a sweep's plan without launching it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .sgbm_ref import SGBMParams

from ..utils import kernels
from . import sgbm as plain
from . import sort_cuda

__all__ = ["LAUNCHES", "reset_launch_counts", "cost_volume",
           "cost_volume_pair", "sgm_pass", "aggregate", "wta_lr",
           "speckle_labels", "speckle_keep", "sweep_labels", "propagate_keep",
           "speckle_keep_seeded", "speckle_filter", "remove_speckles",
           "sgbm_cuda", "sgbm_pair_cuda", "cost_down", "aggregate_i16",
           "wta_lr3", "transpose_vol", "transpose_leading",
           "transpose_dhw_to_wdh", "sgbm_staged_cuda", "sgbm_tile_cuda",
           "tile_bias", "sweeps_take", "sweep_max_width", "agg_route",
           "agg_down", "agg_horiz", "agg_up_wta", "aggregate_wta",
           "UP_WTA_PLANS", "reset_up_wta_plans", "sweep_plan"]

LAUNCHES = {"cost_box": 0, "cost_box_pair": 0, "sgm_pass": 0, "wta_lr": 0,
            "wta_lr_mirror": 0, "speckle_labels": 0, "speckle_keep": 0,
            "sweep_labels": 0, "sweep_propagate": 0, "cost_down": 0,
            "sgm_pass_i16": 0, "wta_lr3": 0, "transpose_vol": 0,
            "transpose_leading": 0, "transpose_dhw": 0, "sgbm_tile": 0,
            "agg_down": 0, "agg_horiz": 0, "agg_up_wta": 0,
            "agg_up_wta_mirror": 0, "agg_lr": 0}
# the up sweep's launch plans, by csrc/tile_sgm.cu's PLAN_* numbers
UP_WTA_PLANS = {"ring": 0, "inline": 0}
_PLAN_NAMES = {1: "inline", 2: "ring"}
I16_MAX = 32767
SWEEP_MAX_SIDE = 32768   # the sweep kernel's largest H and W (csrc/sweep.cu)
SWEEP_MAX_STRIP = 32     # columns of a strip of csrc/tile_sgm.cu, at most


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_up_wta_plans() -> None:
    for k in UP_WTA_PLANS:
        UP_WTA_PLANS[k] = 0


def _count_plan(plan: ctypes.c_int) -> None:
    """Count an up sweep's launch under the plan its entry reported."""
    UP_WTA_PLANS[_PLAN_NAMES[plan.value]] += 1


def sweep_plan(up: bool, B: int, W: int, D: int,
               plan: Optional[str] = None) -> dict:
    """The launch plan of csrc/tile_sgm.cu's down sweep (``up`` False) or
    up sweep with the WTA over B frames W x D on the current card, without
    a launch: the plan's name ("down", or ``UP_WTA_PLANS``'s), its path
    and WTA warps, threads, shared memory bytes, blocks resident a
    multiprocessor, frame slots and waves (0: it cannot launch). ``plan``
    (an up sweep's) forces that plan where the launch would choose."""
    info = (ctypes.c_int * 8)()
    force = {None: 0, **{v: k for k, v in _PLAN_NAMES.items()}}[plan]
    rc = kernels.load().sdr_sweep_plan(int(up), force, B, W, D,
                                       ctypes.addressof(info))
    kernels.check(rc, "sweep_plan")
    keys = ("plan", "path_warps", "wta_warps", "threads", "smem", "per_sm",
            "slots", "waves")
    out = dict(zip(keys, info))
    out["plan"] = _PLAN_NAMES.get(out["plan"], "down")
    return out


def _check_params(params: SGBMParams, *tensors: torch.Tensor) -> None:
    """The kernels' limits on the parameters, applied only where the
    inputs are CUDA tensors: the plain versions run whatever the JAX
    package's jnp matcher runs."""
    if not kernels.on_cuda(*tensors):
        return
    if params.min_disparity < 0:
        raise ValueError("min_disparity < 0 is not supported "
                         "(the TPU kernel asserts the same)")
    if params.num_disparities % 16 or not 16 <= params.num_disparities <= 256:
        raise ValueError("num_disparities must be a multiple of 16 in "
                         f"[16, 256], got {params.num_disparities}")


def _cost_box(lt: torch.Tensor, rt: torch.Tensor, params: SGBMParams,
              pair: bool) -> torch.Tensor:
    """Launch K1 on CUDA images, in pair mode or not."""
    kernels.require(lt, torch.float32, 3, "lt")
    kernels.require(rt, torch.float32, 3, "rt")
    if lt.shape != rt.shape:
        raise ValueError(f"shape mismatch {tuple(lt.shape)} {tuple(rt.shape)}")
    B, H, W = lt.shape
    D = params.num_disparities
    out = torch.empty(((2 if pair else 1) * B, H, W, D), dtype=torch.int16,
                      device=lt.device)
    rc = kernels.load().sdr_cost_box(lt.data_ptr(), rt.data_ptr(),
                                     out.data_ptr(), B, H, W, D,
                                     params.min_disparity, params.block_size,
                                     int(pair), kernels.stream())
    name = "cost_box_pair" if pair else "cost_box"
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def cost_volume(lt: torch.Tensor, rt: torch.Tensor,
                params: SGBMParams) -> torch.Tensor:
    """(B, H, W) Sobel-clipped images -> (B, H, W, D) int16 boxed BT cost."""
    if not kernels.on_cuda(lt, rt):
        return plain.cost_volume(lt, rt, params).to(torch.int16)
    return _cost_box(lt, rt, params, pair=False)


def cost_volume_pair(lt: torch.Tensor, rt: torch.Tensor,
                     params: SGBMParams) -> torch.Tensor:
    """(B, H, W) Sobel-clipped images -> one (2B, H, W, D) int16 volume:
    the left matcher's C_L in frames [0, B) and the right matcher's C_R, in
    un-mirrored orientation, in frames [B, 2B) (``plain.cost_volume_pair``),
    in one launch."""
    if not kernels.on_cuda(lt, rt):
        return torch.cat(plain.cost_volume_pair(lt, rt, params)).to(
            torch.int16)
    return _cost_box(lt, rt, params, pair=True)


def path_sum_bound(params: SGBMParams, n_paths: int) -> int:
    """The largest value a sum of ``n_paths`` path volumes can take: each
    L is at most the largest box cost, block_size^2 * 4 * pre_filter_cap,
    plus P2."""
    cmax = params.block_size ** 2 * 4 * params.pre_filter_cap
    return n_paths * (cmax + params.P2)


def _check_i16(bound: Optional[int], what: str) -> None:
    if bound is None:
        raise ValueError(f"{what}: an int16 sum needs sum_bound, the largest "
                         "value it can take (path_sum_bound)")
    if bound > I16_MAX:
        raise ValueError(f"{what}: the sum can reach {bound}, past int16's "
                         f"{I16_MAX}; use the int32 S")


def sgm_pass(C: torch.Tensor, S: torch.Tensor, dy: int, dx: int,
             P1: int, P2: int, accumulate: bool,
             sum_bound: Optional[int] = None) -> None:
    """One path direction over C (B, H, W, D) int16, written into S in
    place: S = L, or S += L with ``accumulate``. S is int32, or int16 for a
    partial sum; an int16 S needs ``sum_bound``, the largest value the sum
    can take after this pass (``path_sum_bound``), and a bound past 32767
    raises: the kernel never wraps or clamps."""
    if S.dtype == torch.int16:
        _check_i16(sum_bound, "sgm_pass")
    if not kernels.on_cuda(C, S):
        L = plain.directional_pass(C.to(torch.float32), dy, dx,
                                   float(P1), float(P2)).to(S.dtype)
        if accumulate:
            S += L
        else:
            S.copy_(L)
        return
    kernels.require(C, torch.int16, 4, "C")
    i16 = S.dtype == torch.int16
    kernels.require(S, torch.int16 if i16 else torch.int32, 4, "S")
    if C.shape != S.shape:
        raise ValueError(f"shape mismatch {tuple(C.shape)} {tuple(S.shape)}")
    B, H, W, D = C.shape
    lib = kernels.load()
    rc = (lib.sdr_sgm_pass_i16 if i16 else lib.sdr_sgm_pass)(
        C.data_ptr(), S.data_ptr(), B, H, W, D, dy, dx, int(P1), int(P2),
        int(accumulate), kernels.stream())
    name = "sgm_pass_i16" if i16 else "sgm_pass"
    kernels.check(rc, name)
    LAUNCHES[name] += 1


def aggregate_i16(C: torch.Tensor, params: SGBMParams, dirs) -> torch.Tensor:
    """Sum of the directional passes ``dirs`` over C as a (B, H, W, D)
    int16 partial sum; raises ValueError where it could pass int16."""
    dirs = list(dirs)
    S = torch.empty(C.shape, dtype=torch.int16, device=C.device)
    for i, (dy, dx) in enumerate(dirs):
        sgm_pass(C, S, dy, dx, params.P1, params.P2, accumulate=i > 0,
                 sum_bound=path_sum_bound(params, len(dirs)))
    return S


def aggregate(C: torch.Tensor, params: SGBMParams) -> torch.Tensor:
    """Sum of the ``params.num_paths`` directional passes, (B, H, W, D)
    int32."""
    S = torch.empty(C.shape, dtype=torch.int32, device=C.device)
    for i, (dy, dx) in enumerate(params.path_dirs):
        sgm_pass(C, S, dy, dx, params.P1, params.P2, accumulate=i > 0)
    return S


def wta_lr(S: torch.Tensor, params: SGBMParams, apply_lr: bool = True,
           mirror_from: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, D) int32 path sums -> (B, H, W) float32 disparity, -1.0
    where invalid (uniqueness, no partner column, LR check). Frames from
    index ``mirror_from`` on are right-matcher volumes in un-mirrored
    orientation and get the mirrored WTA/LR (``plain.wta_lr``'s
    ``mirror_lr``); None mirrors none."""
    B = S.shape[0]
    m = B if mirror_from is None else mirror_from
    if not 0 <= m <= B:
        raise ValueError(f"mirror_from must be in [0, {B}], got {m}")
    if not kernels.on_cuda(S):
        S = S.to(torch.float32)
        return torch.cat([plain.wta_lr(S[:m], params, apply_lr),
                          plain.wta_lr(S[m:], params, apply_lr,
                                       mirror_lr=True)])
    kernels.require(S, torch.int32, 4, "S")
    _, H, W, D = S.shape
    out = torch.empty((B, H, W), dtype=torch.float32, device=S.device)
    rc = kernels.load().sdr_wta_lr(
        S.data_ptr(), out.data_ptr(), B, H, W, D, params.min_disparity,
        params.uniqueness_ratio, int(params.quantize_16),
        params.disp12_max_diff, int(apply_lr), m, kernels.stream())
    name = "wta_lr" if m == B else "wta_lr_mirror"
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def _sweep(a: torch.Tensor, seed: Optional[torch.Tensor], max_diff: float,
           max_iters: int, name: str) -> torch.Tensor:
    """Launch the sweep kernel (csrc/sweep.cu) on CUDA (B, H, W) inputs:
    labels mode on a float32 disparity ``a`` (``seed`` None), propagate
    mode on int32 labels ``a`` and their int32 ``seed``."""
    B, H, W = a.shape
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if max(H, W) > SWEEP_MAX_SIDE:
        raise ValueError(f"the sweep kernel takes H, W <= {SWEEP_MAX_SIDE}, "
                         f"got {H}x{W}")
    out = torch.empty((B, H, W), dtype=torch.int32, device=a.device)
    link = torch.empty((B, H, W), dtype=torch.uint8, device=a.device)
    flags = torch.empty((3, B), dtype=torch.int32, device=a.device)
    rc = kernels.load().sdr_sweep(
        a.data_ptr(), None if seed is None else seed.data_ptr(),
        out.data_ptr(), link.data_ptr(), flags.data_ptr(), B, H, W,
        float(max_diff), int(max_iters), kernels.stream())
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def sweep_labels(disp: torch.Tensor, max_diff: float,
                 max_iters: int = 0) -> torch.Tensor:
    """``speckle_labels`` by rounds of row and column sweeps (the TPU
    labels kernel's rounds, in its order), on the sweep kernel: to
    convergence, or for at most ``max_iters`` rounds when that is > 0."""
    if not kernels.on_cuda(disp):
        return plain.speckle_labels(disp, max_diff, max_iters)
    kernels.require(disp, torch.float32, 3, "disp")
    return _sweep(disp, None, max_diff, max_iters, "sweep_labels")


def propagate_keep(labels: torch.Tensor, seed: torch.Tensor,
                   max_iters: int = 0) -> torch.Tensor:
    """(B, H, W) int32 labels and seeds -> int32, each seed's max spread
    over the 4-connected runs of equal labels other than H*W
    (``plain.propagate_keep``), on the sweep kernel's propagate mode."""
    if not kernels.on_cuda(labels, seed):
        return plain.propagate_keep(labels, seed, max_iters)
    kernels.require(labels, torch.int32, 3, "labels")
    kernels.require(seed, torch.int32, 3, "seed")
    if labels.shape != seed.shape:
        raise ValueError(f"shape mismatch {tuple(labels.shape)} "
                         f"{tuple(seed.shape)}")
    return _sweep(labels, seed, 0.0, max_iters, "sweep_propagate")


def speckle_keep_seeded(labels: torch.Tensor, max_size: int,
                        max_iters: int = 0) -> torch.Tensor:
    """(B, H, W) int32 labels -> bool, component size > max_size, False for
    the sentinel H*W (the TPU's ``speckle_keep_seeded``): the key sort and
    the large-run roots of ``ops/sort_cuda.py``, a seed scatter, then
    ``propagate_keep``."""
    return plain.speckle_keep_seeded(
        labels, max_size, max_iters, sorted_labels=sort_cuda.sorted_labels,
        large_run_roots=sort_cuda.large_run_roots, propagate=propagate_keep)


def speckle_filter(disp: torch.Tensor, max_size: int, max_diff: float,
                   max_iters: int = 0) -> torch.Tensor:
    """(B, H, W) disparity -> bool, valid (disp >= 0) and in a component of
    more than ``max_size`` pixels: the TPU's ``speckle_filter_pallas``.
    Converged (``max_iters`` 0), K4's labels and K5's keep, as the matcher
    runs them; capped, the sweep kernel's labels and the sort-based keep
    (``sort_cuda.speckle_keep_sorted``), as the JAX package routes it."""
    labels = speckle_labels(disp, max_diff, max_iters)
    if max_iters == 0:
        return speckle_keep(disp, labels, max_size) >= 0
    return (disp >= 0) & sort_cuda.speckle_keep_sorted(labels, max_size)


def speckle_labels(disp: torch.Tensor, max_diff: float,
                   max_iters: int = 0) -> torch.Tensor:
    """(B, H, W) float32 disparity (invalid < 0) -> (B, H, W) int32
    component labels: the smallest flat index of each 4-connected
    component of valid pixels whose disparities differ by at most
    ``max_diff``, H*W for an invalid pixel. Converged (``max_iters`` 0)
    on K4's union-find; capped at ``max_iters`` rounds on the sweep
    kernel (``sweep_labels``)."""
    if not kernels.on_cuda(disp):
        return plain.speckle_labels(disp, max_diff, max_iters)
    if max_iters != 0:
        return sweep_labels(disp, max_diff, max_iters)
    kernels.require(disp, torch.float32, 3, "disp")
    B, H, W = disp.shape
    out = torch.empty((B, H, W), dtype=torch.int32, device=disp.device)
    rc = kernels.load().sdr_speckle_labels(disp.data_ptr(), out.data_ptr(),
                                           B, H, W, float(max_diff),
                                           kernels.stream())
    kernels.check(rc, "speckle_labels")
    LAUNCHES["speckle_labels"] += 1
    return out


def speckle_keep(disp: torch.Tensor, labels: torch.Tensor,
                 max_size: int) -> torch.Tensor:
    """(B, H, W) disparity and its labels -> the disparity where the
    pixel's component has more than ``max_size`` pixels, else -1.0."""
    if not kernels.on_cuda(disp, labels):
        return plain.speckle_keep(disp, labels, max_size)
    kernels.require(disp, torch.float32, 3, "disp")
    kernels.require(labels, torch.int32, 3, "labels")
    if disp.shape != labels.shape:
        raise ValueError(f"shape mismatch {tuple(disp.shape)} "
                         f"{tuple(labels.shape)}")
    B, H, W = disp.shape
    sizes = torch.empty((B, H * W + 1), dtype=torch.int32, device=disp.device)
    out = torch.empty_like(disp)
    rc = kernels.load().sdr_speckle_keep(disp.data_ptr(), labels.data_ptr(),
                                         sizes.data_ptr(), out.data_ptr(),
                                         B, H, W, int(max_size),
                                         kernels.stream())
    kernels.check(rc, "speckle_keep")
    LAUNCHES["speckle_keep"] += 1
    return out


def cost_down(lt: torch.Tensor, rt: torch.Tensor, params: SGBMParams
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) Sobel-clipped images -> (C, S_down3), both (B, H, W, D)
    int16: K1's cost volume and the sum of the down-going passes over it
    (``plain.down_dirs``), from one kernel. Raises ValueError where the sum
    could pass int16."""
    _check_params(params, lt, rt)
    n_dirs = len(plain.down_dirs(params.num_paths))
    _check_i16(path_sum_bound(params, n_dirs), "cost_down")
    if not kernels.on_cuda(lt, rt):
        C, S3 = plain.cost_down(lt, rt, params)
        return C.to(torch.int16), S3.to(torch.int16)
    kernels.require(lt, torch.float32, 3, "lt")
    kernels.require(rt, torch.float32, 3, "rt")
    if lt.shape != rt.shape:
        raise ValueError(f"shape mismatch {tuple(lt.shape)} {tuple(rt.shape)}")
    B, H, W = lt.shape
    D = params.num_disparities
    C = torch.empty((B, H, W, D), dtype=torch.int16, device=lt.device)
    S3 = torch.empty_like(C)
    lib = kernels.load()
    # the strips' edge columns and row counters
    scratch = torch.zeros(lib.sdr_cost_down_scratch_size(B, W, D),
                          dtype=torch.int16, device=lt.device)
    rc = lib.sdr_cost_down(
        lt.data_ptr(), rt.data_ptr(), C.data_ptr(), S3.data_ptr(),
        scratch.data_ptr(), B, H, W, D, params.min_disparity,
        params.block_size, params.P1, params.P2, n_dirs, kernels.stream())
    kernels.check(rc, "cost_down")
    LAUNCHES["cost_down"] += 1
    return C, S3


def wta_lr3(S_down: torch.Tensor, S_up: torch.Tensor, S_h: torch.Tensor,
            params: SGBMParams, apply_lr: bool = True) -> torch.Tensor:
    """Three (B, H, W, D) int16 partial path sums -> (B, H, W) float32
    disparity, -1.0 where invalid: ``wta_lr`` on their sum, which is formed
    in registers and never stored."""
    if not kernels.on_cuda(S_down, S_up, S_h):
        return plain.wta_lr3(S_down, S_up, S_h, params, apply_lr)
    for t, name in ((S_down, "S_down"), (S_up, "S_up"), (S_h, "S_h")):
        kernels.require(t, torch.int16, 4, name)
        if t.shape != S_down.shape:
            raise ValueError(f"shape mismatch {tuple(t.shape)} "
                             f"{tuple(S_down.shape)}")
    B, H, W, D = S_down.shape
    out = torch.empty((B, H, W), dtype=torch.float32, device=S_down.device)
    rc = kernels.load().sdr_wta_lr3(
        S_down.data_ptr(), S_up.data_ptr(), S_h.data_ptr(), out.data_ptr(),
        B, H, W, D, params.min_disparity, params.uniqueness_ratio,
        int(params.quantize_16), params.disp12_max_diff, int(apply_lr),
        kernels.stream())
    kernels.check(rc, "wta_lr3")
    LAUNCHES["wta_lr3"] += 1
    return out


def _transpose(x: torch.Tensor, name: str, out_shape, plain_fn
               ) -> torch.Tensor:
    """Launch one of the transposes of csrc/transpose.cu on a CUDA volume
    of 2- or 4-byte elements; the bits move unchanged."""
    if not kernels.on_cuda(x):
        return plain_fn(x)
    if x.dim() != 3 or not x.is_contiguous() or x.element_size() not in (2, 4):
        raise ValueError(f"{name}: need a contiguous 3-d tensor of 2- or "
                         f"4-byte elements, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if x.numel():
        rc = getattr(kernels.load(), "sdr_" + name)(
            x.data_ptr(), out.data_ptr(), *x.shape, x.element_size(),
            kernels.stream())
        kernels.check(rc, name)
        LAUNCHES[name] += 1
    return out


def transpose_vol(x: torch.Tensor) -> torch.Tensor:
    """(A, D, B) -> (B, D, A): the JAX package's ``transpose_vol_pallas``."""
    A, D, B = x.shape
    return _transpose(x, "transpose_vol", (B, D, A), plain.transpose_vol)


def transpose_leading(x: torch.Tensor) -> torch.Tensor:
    """(A, B, W) -> (B, A, W): ``transpose_leading_pallas``."""
    A, B, W = x.shape
    return _transpose(x, "transpose_leading", (B, A, W),
                      plain.transpose_leading)


def transpose_dhw_to_wdh(x: torch.Tensor) -> torch.Tensor:
    """(D, H, W) -> (W, D, H): ``transpose_dhw_to_wdh_pallas``."""
    D, H, W = x.shape
    return _transpose(x, "transpose_dhw", (W, D, H),
                      plain.transpose_dhw_to_wdh)


def sgbm_staged_cuda(left: torch.Tensor, right: torch.Tensor,
                     params: SGBMParams = SGBMParams(), apply_lr: bool = True,
                     apply_speckle: bool = True) -> torch.Tensor:
    """``sgbm_cuda`` by the staged chain, equal to it bit for bit:
    ``cost_down``, two horizontal and one or three up-going passes into
    int16 partial sums, ``wta_lr3``, then the speckle filter. Needs 4 or 8
    paths and partial sums that fit int16 (ValueError otherwise)."""
    _check_params(params, left, right)
    if params.num_paths < 4:
        raise ValueError("the staged chain needs 4 or 8 paths, got "
                         f"{params.num_paths}")
    lt, rt = _sobel_pair(left, right, params)
    C, S_down = cost_down(lt, rt, params)
    S_h = aggregate_i16(C, params, [(0, 1), (0, -1)])
    S_up = aggregate_i16(C, params, plain.up_dirs(params.num_paths))
    if not kernels.on_cuda(C):
        return plain.wta_lr_speckle(S_down.float() + S_up.float()
                                    + S_h.float(), params, apply_lr,
                                    apply_speckle)
    disp = wta_lr3(S_down, S_up, S_h, params, apply_lr)
    del C, S_down, S_h, S_up
    return remove_speckles(disp, params) if apply_speckle else disp


def tile_bias(params: SGBMParams) -> Optional[int]:
    """The tile matcher's route, as the JAX package's ``_wta_bias`` picks it
    for an int16 slab: S_dh, the sum of the down-going and the two
    horizontal paths, reaches at most max_sum = ``path_sum_bound`` over
    those paths; below 32000 it fits int16 as it is (bias 0), below 65000
    shifted down by max_sum // 2; past that None: the int32 route."""
    max_sum = path_sum_bound(params, len(plain.down_dirs(params.num_paths))
                             + 2)
    if max_sum < 32000:
        return 0
    if max_sum < 65000:
        return max_sum // 2
    return None


def _agg_scratch(lib, C: torch.Tensor) -> torch.Tensor:
    """The zeroed edge-exchange scratch of one sweep over the (B, ., W, D)
    volume C (a tile's slab: B = 1)."""
    B, _, W, D = C.shape
    n = lib.sdr_agg_scratch_size(B, W, D)
    if n < 0:
        raise RuntimeError(f"sdr_agg_scratch_size({B}, {W}, {D}) failed")
    return torch.zeros(n, dtype=torch.int16, device=C.device)


def _sgbm_tile_i32(C: torch.Tensor, params: SGBMParams, top_halo: int,
                   apply_lr: bool) -> torch.Tensor:
    """The int32 route: the down-going K2 passes over all M rows into an
    int32 S, the horizontal and up-going ones accumulated into its rows
    below the top halo, then K3 on those rows."""
    S_all = torch.empty(C.shape, dtype=torch.int32, device=C.device)
    for i, (dy, dx) in enumerate(plain.down_dirs(params.num_paths)):
        sgm_pass(C, S_all, dy, dx, params.P1, params.P2, accumulate=i > 0)
    # the top halo's rows are the down passes' warm-up only
    body, S = C[:, top_halo:], S_all[:, top_halo:]
    for dy, dx in [(0, 1), (0, -1)] + plain.up_dirs(params.num_paths):
        sgm_pass(body, S, dy, dx, params.P1, params.P2, accumulate=True)
    return wta_lr(S, params, apply_lr)


def sgbm_tile_cuda(C: torch.Tensor, params: SGBMParams, top_halo: int = 0,
                   bottom_halo: int = 0, apply_lr: bool = True
                   ) -> torch.Tensor:
    """``plain.sgbm_tile`` of a (1, M, W, D) int16 cost slab, M = top_halo
    + local + bottom_halo -> (1, local, W) float32 disparity, -1.0 where
    invalid. Where ``tile_bias`` gives a bias, the three sweeps of
    csrc/tile_sgm.cu on an int16 S_dh (``agg_down`` with the top halo,
    ``agg_horiz``, ``agg_up_wta`` of the local rows); where it gives None,
    K2 x8 into an int32 S and K3 (``_sgbm_tile_i32``). One frame a call: a
    row slice of a batch of frames is not contiguous, one of a single
    frame is."""
    if not kernels.on_cuda(C):
        return plain.sgbm_tile(C, params, top_halo, bottom_halo, apply_lr)
    _check_params(params, C)
    _require_batch(C, params, "C")
    if C.shape[0] != 1:
        raise ValueError(f"C: need a (1, M, W, {params.num_disparities}) "
                         f"slab, got {tuple(C.shape)}")
    local = plain._tile_local(C.shape[1], params, top_halo, bottom_halo)
    bias = tile_bias(params)
    if bias is None:
        disp = _sgbm_tile_i32(C, params, top_halo, apply_lr)[:, :local]
    else:
        S_dh = agg_down(C, params, bias, top_halo)
        body = C[:, top_halo:]
        agg_horiz(body, S_dh, params)
        disp = agg_up_wta(body, S_dh, params, bias, apply_lr, local=local)
    LAUNCHES["sgbm_tile"] += 1
    return disp


def sweeps_take(D: int) -> bool:
    """Whether the sweeps of csrc/tile_sgm.cu take D disparities: 16 to
    256, a multiple of 16."""
    return 16 <= D <= 256 and D % 16 == 0


def sweep_max_width(device: torch.device) -> Optional[int]:
    """The widest frame the sweeps of csrc/tile_sgm.cu take on ``device``:
    every strip of a frame is resident at once, at most one a
    multiprocessor of at most ``SWEEP_MAX_STRIP`` columns (4224 on an
    H100); None on the CPU, whose plain stages take any width."""
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    return SWEEP_MAX_STRIP * props.multi_processor_count


def agg_route(params: SGBMParams, fused_wta: bool = True, width: int = 0,
              max_width: Optional[int] = None) -> str:
    """The matcher's aggregation route, from the parameters and shapes
    alone, before any launch, as ``sgbm_pallas`` picks its branch:
    "sweeps" (the batch sweeps on an int16 S_dh, the JAX
    ``_fused_aggregate_wta`` with a bias) where ``fused_wta``, 4 or 8
    paths, ``tile_bias`` not None, D one the sweeps take and ``width`` at
    most ``max_width`` (``sweep_max_width``; None: any width); else
    "passes" (K2 per direction into an int32 S, then K3), whose output
    equals the JAX three-volume and unfused branches."""
    if (fused_wta and params.num_paths >= 4
            and tile_bias(params) is not None
            and sweeps_take(params.num_disparities)
            and (max_width is None or width <= max_width)):
        return "sweeps"
    return "passes"


def _require_batch(C: torch.Tensor, params: SGBMParams, name: str,
                   S_dh: Optional[torch.Tensor] = None) -> None:
    """A (B, H, W, D) int16 volume, and S_dh of its shape where given."""
    kernels.require(C, torch.int16, 4, name)
    if C.shape[3] != params.num_disparities:
        raise ValueError(f"{name}: need (B, H, W, {params.num_disparities}), "
                         f"got {tuple(C.shape)}")
    if S_dh is not None:
        kernels.require(S_dh, torch.int16, 4, "S_dh")
        if S_dh.shape != C.shape:
            raise ValueError(f"shape mismatch {tuple(C.shape)} "
                             f"{tuple(S_dh.shape)}")


def agg_down(C: torch.Tensor, params: SGBMParams, bias: int,
             top_halo: int = 0) -> torch.Tensor:
    """(B, H, W, D) int16 cost volume -> (B, H - top_halo, W, D) int16
    S_dh: the down-going paths (``plain.down_dirs``) over all H rows minus
    ``bias``, on the rows below the top halo, which only warm the paths up
    (a tile's, for K9; ``plain.tile_down_sum`` of each frame), from the
    down sweep of csrc/tile_sgm.cu over the whole batch. The caller keeps
    S_dh within int16 (``tile_bias``)."""
    if not kernels.on_cuda(C):
        return plain.tile_down_sum(C, params, top_halo, bias).to(torch.int16)
    _require_batch(C, params, "C")
    B, H, W, D = C.shape
    S = torch.empty((B, H - top_halo, W, D), dtype=torch.int16,
                    device=C.device)
    lib = kernels.load()
    scratch = _agg_scratch(lib, C)
    rc = lib.sdr_agg_down(C.data_ptr(), S.data_ptr(), scratch.data_ptr(), B,
                          H, W, D, top_halo, int(bias), params.P1, params.P2,
                          len(plain.down_dirs(params.num_paths)),
                          kernels.stream())
    kernels.check(rc, "agg_down")
    LAUNCHES["agg_down"] += 1
    return S


def agg_horiz(C: torch.Tensor, S_dh: torch.Tensor,
              params: SGBMParams) -> None:
    """Both horizontal paths over the (B, H, W, D) int16 volume added into
    S_dh in place (``plain.tile_horizontal``): the horizontal sweep of
    csrc/tile_sgm.cu on its B * H rows."""
    if not kernels.on_cuda(C, S_dh):
        S_dh.copy_(plain.tile_horizontal(C, S_dh, params))
        return
    _require_batch(C, params, "C", S_dh)
    B, H, W, D = C.shape
    rc = kernels.load().sdr_agg_horiz(C.data_ptr(), S_dh.data_ptr(), B * H,
                                      W, D, params.P1, params.P2,
                                      kernels.stream())
    kernels.check(rc, "agg_horiz")
    LAUNCHES["agg_horiz"] += 1


def _agg_up(C: torch.Tensor, S_dh: torch.Tensor, params: SGBMParams,
            bias: int, lr: bool, m: int, local: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the batch up sweep with the WTA on CUDA volumes: the (B,
    local, W) disparity of each frame's first ``local`` rows before the LR
    check and, with ``lr``, the (B, local, W) int32 winner scatter that the
    LR pass reads; frames from ``m`` on mirrored."""
    _require_batch(C, params, "C", S_dh)
    if params.min_disparity < 0:
        raise ValueError("the batch sweeps need min_disparity >= 0, got "
                         f"{params.min_disparity}")
    B, H, W, D = C.shape
    out = torch.empty((B, local, W), dtype=torch.float32, device=C.device)
    d2p = torch.empty((B, local, W) if lr else (1,), dtype=torch.int32,
                      device=C.device)
    lib = kernels.load()
    scratch = _agg_scratch(lib, C)
    plan = ctypes.c_int(0)
    rc = lib.sdr_agg_up_wta(
        C.data_ptr(), S_dh.data_ptr(), out.data_ptr(), d2p.data_ptr(),
        scratch.data_ptr(), B, H, W, D, local, int(bias), params.P1,
        params.P2, len(plain.up_dirs(params.num_paths)),
        params.min_disparity, params.uniqueness_ratio,
        int(params.quantize_16), int(lr), m, ctypes.addressof(plan),
        kernels.stream())
    name = "agg_up_wta" if m == B else "agg_up_wta_mirror"
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    _count_plan(plan)
    return out, d2p


def _agg_lr(out: torch.Tensor, d2p: torch.Tensor, params: SGBMParams,
            m: int) -> None:
    """Launch the batch LR pass on ``_agg_up``'s outputs, in place."""
    B, H, W = out.shape
    rc = kernels.load().sdr_agg_lr(out.data_ptr(), d2p.data_ptr(), B, H, W,
                                   params.num_disparities,
                                   params.min_disparity,
                                   params.disp12_max_diff, m,
                                   kernels.stream())
    kernels.check(rc, "agg_lr")
    LAUNCHES["agg_lr"] += 1


def agg_up_wta(C: torch.Tensor, S_dh: torch.Tensor, params: SGBMParams,
               bias: int, apply_lr: bool = True,
               mirror_from: Optional[int] = None,
               local: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, D) int16 cost volume and S_dh -> (B, local, W) float32
    disparity of each frame's first ``local`` rows (None: all H; K9 passes
    its tile's rows), -1.0 where invalid: the up-going paths from the last
    row, fused with the WTA on S_dh + bias + L_up (``plain.tile_up_wta``
    of each frame), then the LR pass; csrc/tile_sgm.cu over the whole
    batch. Frames from ``mirror_from`` on (None: none) are right-matcher
    volumes in un-mirrored orientation and get the mirrored WTA/LR."""
    B, H = C.shape[:2]
    m = B if mirror_from is None else mirror_from
    if not 0 <= m <= B:
        raise ValueError(f"mirror_from must be in [0, {B}], got {m}")
    local = H if local is None else local
    if not kernels.on_cuda(C, S_dh):
        return torch.cat([plain.tile_up_wta(C[a:b], S_dh[a:b], params, bias,
                                            apply_lr, mirror_lr=mirror)
                          for a, b, mirror in ((0, m, False), (m, B, True))
                          if b > a])[..., :local, :]
    lr = apply_lr and params.disp12_max_diff >= 0
    out, d2p = _agg_up(C, S_dh, params, bias, lr, m, local)
    if lr:
        _agg_lr(out, d2p, params, m)
    return out


def aggregate_wta(C: torch.Tensor, params: SGBMParams, apply_lr: bool = True,
                  mirror_from: Optional[int] = None,
                  fused_wta: bool = True) -> torch.Tensor:
    """(B, H, W, D) int16 cost volume -> (B, H, W) float32 disparity, -1.0
    where invalid: the path sum's WTA and LR check on the route
    ``agg_route`` picks for C's width and device, the batch sweeps
    (``agg_down``, ``agg_horiz``, ``agg_up_wta``) or K2 per direction and
    K3. Both give the same bits. ``mirror_from`` as in ``wta_lr``."""
    if agg_route(params, fused_wta, C.shape[2],
                 sweep_max_width(C.device)) == "sweeps":
        bias = tile_bias(params)
        S_dh = agg_down(C, params, bias)
        agg_horiz(C, S_dh, params)
        return agg_up_wta(C, S_dh, params, bias, apply_lr, mirror_from)
    return wta_lr(aggregate(C, params), params, apply_lr, mirror_from)


def sgbm_cuda(left: torch.Tensor, right: torch.Tensor,
              params: SGBMParams = SGBMParams(), apply_lr: bool = True,
              apply_speckle: bool = True,
              fused_wta: bool = True) -> torch.Tensor:
    """(B, H, W) float32 pair -> (B, H, W) float32 disparity, invalid -1.0:
    K1, ``aggregate_wta`` (WTA and the LR check; ``fused_wta`` as in
    ``sgbm_pallas``), then, with ``apply_speckle``, the speckle filter when
    ``speckle_window_size > 0``, told validity by the WTA/LR mask."""
    _check_params(params, left, right)
    lt, rt = _sobel_pair(left, right, params)
    C = cost_volume(lt, rt, params)
    if not kernels.on_cuda(C):
        return plain.wta_lr_speckle(aggregate(C, params).float(), params,
                                    apply_lr, apply_speckle)
    disp = aggregate_wta(C, params, apply_lr, fused_wta=fused_wta)
    del C
    return remove_speckles(disp, params) if apply_speckle else disp


def _sobel_pair(left: torch.Tensor, right: torch.Tensor, params: SGBMParams
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if left.dim() != 3 or left.shape != right.shape:
        raise ValueError(f"need two (B, H, W) images of one shape, got "
                         f"{tuple(left.shape)} {tuple(right.shape)}")
    cap = params.pre_filter_cap
    return (plain.sobel_clip(left, cap).contiguous(),
            plain.sobel_clip(right, cap).contiguous())


def remove_speckles(disp: torch.Tensor, params: SGBMParams
                    ) -> torch.Tensor:
    """(B, H, W) float32 disparity -> the same with every component (4-
    connected, neighbours within ``speckle_range``) of at most
    ``speckle_window_size`` pixels set to -1.0, none where that is 0: the
    speckle filter with disp >= 0 as the validity mask, right on
    CUDA maps (the kernels refuse a negative min_disparity) and for the
    pair (min_disparity 0). ``sgbm_cuda`` and ``sgbm_staged_cuda`` on CPU
    tensors take ``plain.wta_lr_speckle`` instead, which keeps the WTA/LR
    mask, so valid negative disparities survive there."""
    if params.speckle_window_size > 0:
        labels = speckle_labels(disp, params.speckle_range)
        disp = speckle_keep(disp, labels, params.speckle_window_size)
    return disp


def sgbm_pair_cuda(left: torch.Tensor, right: torch.Tensor,
                   params: SGBMParams = SGBMParams(), fused_wta: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) float32 pair -> the left and the right matcher's (B, H, W)
    disparities, invalid -1.0, from one pair volume: K1's pair mode writes
    both volumes into one (2B, H, W, D) buffer, ``aggregate_wta`` runs all
    2B frames with the right half in mirror mode (the path sum is
    mirror-equivariant, so the right volume needs no mirrored pass), as the
    JAX pair batches its passes, then the speckle filter on all 2B maps.
    Bitwise equal to ``sgbm_cuda`` on the stacked pair (the right matcher
    on mirrored, swapped frames, flipped back) at every width."""
    _check_params(params, left, right)
    if params.min_disparity != 0:
        raise ValueError("the shared-cost pair needs min_disparity 0, got "
                         f"{params.min_disparity}")
    if params.num_paths < 4:
        raise ValueError("the shared-cost pair needs 4 or 8 paths, got "
                         f"{params.num_paths}")
    lt, rt = _sobel_pair(left, right, params)
    B = lt.shape[0]
    C = cost_volume_pair(lt, rt, params)
    disp = aggregate_wta(C, params, mirror_from=B, fused_wta=fused_wta)
    del C
    disp = remove_speckles(disp, params)
    return disp[:B], disp[B:]
