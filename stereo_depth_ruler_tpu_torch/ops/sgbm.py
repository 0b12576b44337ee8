"""Semi-global matching in plain PyTorch — the kernels' plain versions.

Port of ``stereo_depth_ruler_tpu/ops/sgbm.py`` (the jnp matcher) with the
same ``(H, W, D)`` float32 semantics and the same ``_BIG = 1e9`` border
value. Every function also takes leading batch dimensions, ``(..., H, W)``
images and ``(..., H, W, D)`` volumes, so that one call covers a batch.

All cost and path values are exact small integers held in float32
(``sgbm_ref.py`` spec), so this module is bit-identical to the jnp matcher
and to the NumPy oracle. It is what the CPU runs, and what the CUDA kernels
in ``ops/sgbm_cuda.py`` are held against on the card. Nothing here uses a
convolution: cuDNN would compute it in TF32 and break the exactness.

The speckle filter is the plain version of the CCL labels and keep kernels
(csrc/speckle.cu): labels by the segmented-min sweeps of the TPU labels
kernel, iterated to convergence or for a capped number of rounds, then a
histogram of the labels. ``propagate_keep`` (the same rounds with max in
place of min) and ``speckle_keep_seeded`` are the plain versions of the
sweep kernel's propagate mode (csrc/sweep.cu) and of the TPU's seeded
keep, which also runs the sort family of ``ops/sort.py``.

The shared-cost pair (``sgbm_pair``) runs the right matcher on a volume in
un-mirrored orientation: ``cost_volume_pair`` defines it as the mirrored
build flipped back, and ``wta_lr(..., mirror_lr=True)`` is the WTA/LR of
the mirrored volume flipped back, written without the flips. The 8-path
sum needs no mirrored form: its directions are closed under dx -> -dx.

The staged chain (``sgbm_staged``) is the matcher on partial path sums:
``cost_down`` gives the cost volume and the down-going sum together,
separate passes the horizontal and the up-going sums, and ``wta_lr3`` takes
the three. ``transpose_vol``, ``transpose_leading`` and
``transpose_dhw_to_wdh`` are the plain versions of the volume transposes
(csrc/transpose.cu); the port's own layout needs none of them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import sort
from .sgbm_ref import SGBMParams

__all__ = ["SGBMParams", "sobel_clip", "bt_cost_volume", "box_filter_volume",
           "cost_volume", "directional_pass", "aggregate_paths", "wta",
           "lr_check", "wta_lr", "speckle_labels", "speckle_keep",
           "propagate_keep", "speckle_keep_seeded", "speckle_filter", "sgbm",
           "compute_disparity_pair", "cost_volume_pair", "sgbm_pair",
           "down_dirs", "up_dirs", "cost_down", "wta_lr3", "sgbm_staged",
           "transpose_vol", "transpose_leading", "transpose_dhw_to_wdh"]

_BIG = 1e9
_BIGI = 2 ** 28   # "infinity" of the integer label sweeps


def _pad_edge(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """Replicate ``r`` border slices on both sides of ``dim``."""
    if r == 0:
        return x
    shape = list(x.shape)
    shape[dim] = r
    lo = x.narrow(dim, 0, 1).expand(shape)
    hi = x.narrow(dim, x.shape[dim] - 1, 1).expand(shape)
    return torch.cat([lo, x, hi], dim=dim)


def sobel_clip(img: torch.Tensor, cap: int) -> torch.Tensor:
    """3x3 x-Sobel clipped to [0, 2*cap], replicate border. (..., H, W).

    The image is truncated to an integer first (``.to(torch.int32)``, as
    the jnp matcher's ``astype(int32)``), so every downstream value is an
    exact small integer."""
    img = img.to(torch.int32).to(torch.float32)
    p = _pad_edge(_pad_edge(img, -2, 1), -1, 1)
    gx = (2.0 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
          + (p[..., :-2, 2:] - p[..., :-2, :-2])
          + (p[..., 2:, 2:] - p[..., 2:, :-2]))
    return torch.clamp(gx, -cap, cap) + cap


def _bt_minmax(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    v = img
    vm = torch.cat([v[..., :1], 0.5 * (v[..., 1:] + v[..., :-1])], dim=-1)
    vp = torch.cat([0.5 * (v[..., :-1] + v[..., 1:]), v[..., -1:]], dim=-1)
    imin = torch.minimum(torch.minimum(vm, vp), v)
    imax = torch.maximum(torch.maximum(vm, vp), v)
    return imin, imax


def bt_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                   min_disp: int = 0) -> torch.Tensor:
    """Birchfield–Tomasi cost volume (..., H, W, D) float32, doubled so it
    stays integral. Right x-coordinates clamp to the border columns."""
    W = left.shape[-1]
    lmin, lmax = _bt_minmax(left)
    rmin, rmax = _bt_minmax(right)
    xs = torch.arange(W, device=left.device)[:, None]
    ds = torch.arange(num_disp, device=left.device)[None, :] + min_disp
    xr = torch.clamp(xs - ds, 0, W - 1)            # (W, D)

    def gather(a):                                  # (..., H, W) -> (..., H, W, D)
        return a[..., xr]

    lv = left[..., None]
    rv = gather(right)
    zero = torch.zeros((), dtype=left.dtype, device=left.device)
    c_lr = torch.maximum(zero, torch.maximum(lv - gather(rmax),
                                             gather(rmin) - lv))
    c_rl = torch.maximum(zero, torch.maximum(rv - lmax[..., None],
                                             lmin[..., None] - rv))
    return 2.0 * torch.minimum(c_lr, c_rl)


def box_filter_volume(cost: torch.Tensor, block: int) -> torch.Tensor:
    """block x block window sum over the (H, W) axes of (..., H, W, D),
    replicate border: slices and adds, never a convolution."""
    r = block // 2
    H, W = cost.shape[-3], cost.shape[-2]
    p = _pad_edge(cost, -3, r)
    out = sum(p[..., dy:dy + H, :, :] for dy in range(block))
    p = _pad_edge(out, -2, r)
    return sum(p[..., dx:dx + W, :] for dx in range(block))


def cost_volume(lt: torch.Tensor, rt: torch.Tensor,
                params: SGBMParams) -> torch.Tensor:
    """Boxed BT cost of Sobel-clipped images, (..., H, W, D) float32: the
    plain version of the cost kernel (csrc/cost_box.cu)."""
    C = bt_cost_volume(lt, rt, params.num_disparities, params.min_disparity)
    return box_filter_volume(C, params.block_size)


def cost_volume_pair(lt: torch.Tensor, rt: torch.Tensor, params: SGBMParams
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C_L, C_R) of Sobel-clipped (..., H, W) images: C_L is
    ``cost_volume(lt, rt)``, C_R the right matcher's volume in un-mirrored
    orientation, the cost volume of the mirrored, swapped images flipped
    back along W. The Sobel of a mirrored image is 2*cap minus the mirrored
    Sobel. The plain version of the cost kernel's pair mode, which gets
    C_R from C_L by the shear C_R(y, x, d) = C_L(y, x + d + md, d) wherever
    no box window reaches a border column."""
    cap = params.pre_filter_cap
    lt_m = (2.0 * cap - rt).flip(-1)
    rt_m = (2.0 * cap - lt).flip(-1)
    return (cost_volume(lt, rt, params),
            cost_volume(lt_m, rt_m, params).flip(-2))


def _dp_update(Lprev: torch.Tensor, c: torch.Tensor,
               P1: float, P2: float) -> torch.Tensor:
    """One SGM step: Lprev (..., D) predecessor, c (..., D) cost -> L."""
    minL = Lprev.amin(dim=-1, keepdim=True)
    big = torch.full_like(Lprev[..., :1], _BIG)
    lm1 = torch.cat([big, Lprev[..., :-1]], dim=-1)
    lp1 = torch.cat([Lprev[..., 1:], big], dim=-1)
    best = torch.minimum(torch.minimum(Lprev, minL + P2),
                         torch.minimum(lm1, lp1) + P1)
    return c + best - minL


def directional_pass(cost: torch.Tensor, dy: int, dx: int,
                     P1: float, P2: float) -> torch.Tensor:
    """One SGM path L_r for direction r = (dy, dx) over (..., H, W, D).

    A horizontal path scans over W with a (..., H, D) carry; every other
    path scans over H with a (..., W, D) carry that is shifted by dx along
    W per row, the vacated column entering as the zero state (a path that
    starts at the image border: L = C there)."""
    if dy == 0:
        cw = cost.movedim(-2, 0)                   # (W, ..., H, D)
        order = range(cw.shape[0]) if dx > 0 else range(cw.shape[0] - 1,
                                                        -1, -1)
        carry = torch.zeros_like(cw[0])
        out = [None] * cw.shape[0]
        for x in order:
            carry = _dp_update(carry, cw[x], P1, P2)
            out[x] = carry
        return torch.stack(out, dim=0).movedim(0, -2)
    ch = cost.movedim(-3, 0)                       # (H, ..., W, D)
    order = range(ch.shape[0]) if dy > 0 else range(ch.shape[0] - 1, -1, -1)
    carry = torch.zeros_like(ch[0])
    z = torch.zeros_like(carry[..., :1, :])
    out = [None] * ch.shape[0]
    for y in order:
        if dx > 0:
            carry = torch.cat([z, carry[..., :-1, :]], dim=-2)
        elif dx < 0:
            carry = torch.cat([carry[..., 1:, :], z], dim=-2)
        carry = _dp_update(carry, ch[y], P1, P2)
        out[y] = carry
    return torch.stack(out, dim=0).movedim(0, -3)


def aggregate_paths(cost: torch.Tensor, P1: float, P2: float,
                    num_paths: int = 8) -> torch.Tensor:
    """S = sum of L_r over the 2, 4 or 8 paths of ``sgbm_ref.PATH_DIRS_*``.
    Path values are exact integers, so the order of the sum is free."""
    if num_paths not in (2, 4, 8):
        raise ValueError(f"num_paths must be 2, 4 or 8, got {num_paths}")
    dirs = SGBMParams(num_paths=num_paths).path_dirs
    S = torch.zeros_like(cost)
    for dy, dx in dirs:
        S += directional_pass(cost, dy, dx, float(P1), float(P2))
    return S


def wta(S: torch.Tensor, params: SGBMParams, mirror_lr: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all + uniqueness + subpixel -> (disp f32, valid bool),
    the rules of ``sgbm_ref.wta_np``. Ties go to the smallest d. A column
    whose partner x - d* - md (x + d* + md with ``mirror_lr``) lies outside
    the image is invalid."""
    D, W = S.shape[-1], S.shape[-2]
    d_star = torch.argmin(S, dim=-1)
    s0 = S.amin(dim=-1)
    valid = torch.ones_like(s0, dtype=torch.bool)
    if params.uniqueness_ratio > 0:
        thresh = s0 * ((100 + params.uniqueness_ratio) / 100.0)
        ds = torch.arange(D, device=S.device)
        far = (ds - d_star[..., None]).abs() > 1
        bad = ((S < thresh[..., None]) & far).any(dim=-1)
        valid &= ~bad
    dm = torch.clamp(d_star - 1, 0, D - 1)
    dp = torch.clamp(d_star + 1, 0, D - 1)
    sm = torch.gather(S, -1, dm[..., None])[..., 0]
    sp = torch.gather(S, -1, dp[..., None])[..., 0]
    denom = torch.clamp(sm + sp - 2.0 * s0, min=1e-6)
    offset = torch.clamp((sm - sp) / (2.0 * denom), -0.5, 0.5)
    offset = torch.where((d_star == 0) | (d_star == D - 1),
                         torch.zeros_like(offset), offset)
    disp = (d_star.to(torch.float32) + offset) + params.min_disparity
    if params.quantize_16:
        disp = torch.round(disp * 16.0) / 16.0
    xs = torch.arange(W, device=S.device)
    if mirror_lr:
        valid &= xs + d_star + params.min_disparity <= W - 1
    else:
        valid &= (d_star + params.min_disparity) <= xs
    return disp.to(torch.float32), valid


def _winner_scatter_disp2(s0i: torch.Tensor, d_star: torch.Tensor,
                          D: int, min_disp: int,
                          mirror_lr: bool = False) -> torch.Tensor:
    """Right-view disparity from the per-column WTA winners (OpenCV's
    internal disp2): the winner (s0, d*) of column x lands at
    x - d* - min_disp (x + d* + min_disp with ``mirror_lr``); collisions
    keep the lower cost, ties the smaller d. D masked shifts of an int32
    (cost, d)-packed map.

    s0i, d_star: (..., W) int32. Returns (..., W) float32, -1 where no
    winner landed."""
    W = s0i.shape[-1]
    md = min_disp
    PK = 1 << int(D + md).bit_length()
    BIGP = 2 ** 30
    packed = s0i * PK + d_star + md
    disp2p = torch.full_like(packed, BIGP)
    for d in range(D):
        s = d + md
        if s >= W:
            break
        cand = packed
        if s:
            fill = torch.full_like(packed[..., :s], BIGP)
            cand = (torch.cat([fill, packed[..., :W - s]], dim=-1)
                    if mirror_lr else
                    torch.cat([packed[..., s:], fill], dim=-1))
        okm = (cand & (PK - 1)) == s
        disp2p = torch.minimum(disp2p, torch.where(okm, cand,
                                                   torch.full_like(cand,
                                                                   BIGP)))
    return torch.where(disp2p < BIGP, (disp2p & (PK - 1)).to(torch.float32),
                       torch.full_like(disp2p, -1, dtype=torch.float32))


def lr_check(S: torch.Tensor, disp: torch.Tensor, valid: torch.Tensor,
             params: SGBMParams, mirror_lr: bool = False) -> torch.Tensor:
    """Consistency check against the right-view disparity built from the
    per-column WTA winners of the same volume (``sgbm_ref.lr_check_np``),
    read at x - round(disp) (x + round(disp) with ``mirror_lr``)."""
    if params.disp12_max_diff < 0:
        return valid
    D, W = S.shape[-1], S.shape[-2]
    d_star = torch.argmin(S, dim=-1).to(torch.int32)
    s0i = S.amin(dim=-1).to(torch.int32)            # exact small ints
    disp2 = _winner_scatter_disp2(s0i, d_star, D, params.min_disparity,
                                  mirror_lr)
    rd = torch.round(disp).to(torch.int32)
    xs = torch.arange(W, device=S.device, dtype=torch.int32)
    xr = xs + rd if mirror_lr else xs - rd
    xr_ok = (xr >= 0) & (xr <= W - 1)
    d2 = torch.gather(disp2, -1, torch.clamp(xr, 0, W - 1).to(torch.int64))
    consistent = (d2 >= 0) & ((d2 - disp).abs() <= params.disp12_max_diff)
    return valid & torch.where(xr_ok, consistent, torch.ones_like(xr_ok))


def wta_lr(S: torch.Tensor, params: SGBMParams, apply_lr: bool = True,
           mirror_lr: bool = False) -> torch.Tensor:
    """wta, then lr_check, then -1.0 where invalid: the plain version of
    the WTA/LR kernel (csrc/wta_lr.cu). With ``mirror_lr`` S is a right
    view's volume in un-mirrored orientation (the secondary view lies at
    x + d), and the result equals ``wta_lr(S.flip(-2)).flip(-1)``."""
    disp, valid = wta(S, params, mirror_lr)
    if apply_lr:
        valid = lr_check(S, disp, valid, params, mirror_lr)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def _shift(x: torch.Tensor, k: int, dim: int, fill) -> torch.Tensor:
    """x[i - k] along ``dim`` for k > 0, x[i + |k|] for k < 0; ``fill``
    where that index falls outside."""
    n = x.shape[dim]
    if abs(k) >= n:
        return torch.full_like(x, fill)
    pad = torch.full_like(x.narrow(dim, 0, abs(k)), fill)
    if k > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - k)], dim=dim)
    return torch.cat([x.narrow(dim, -k, n + k), pad], dim=dim)


def _segmented_sweep(lab: torch.Tensor, conn: torch.Tensor, dim: int,
                     reverse: bool, op=torch.minimum,
                     fill: int = _BIGI) -> torch.Tensor:
    """``op`` (min, or max with fill 0) of ``lab`` over each element's run
    up to it along ``dim`` (from below, or from above with ``reverse``);
    conn[i] links element i to element i-1. Log-doubling, as the TPU
    labels kernel's sweep."""
    n = lab.shape[dim]
    c = _shift(conn, -1, dim, False) if reverse else conn
    val = lab
    k = 1
    while k < n:
        step = -k if reverse else k
        v_n = _shift(val, step, dim, fill)
        c_n = _shift(c, step, dim, False)
        val = torch.where(c, op(val, v_n), val)
        c = c & c_n
        k *= 2
    return val


def _sweep_rounds(val: torch.Tensor, c_h: torch.Tensor, c_v: torch.Tensor,
                  max_iters: int, op=torch.minimum,
                  fill: int = _BIGI) -> torch.Tensor:
    """Rounds of segmented sweeps of ``op`` over linked runs: rows forward,
    rows backward, columns forward, columns backward. They run until a
    round changes nothing, or for at most ``max_iters`` rounds when that
    is > 0. The round order matters for a capped result."""
    rounds = 0
    while True:
        new = _segmented_sweep(val, c_h, -1, False, op, fill)
        new = _segmented_sweep(new, c_h, -1, True, op, fill)
        new = _segmented_sweep(new, c_v, -2, False, op, fill)
        new = _segmented_sweep(new, c_v, -2, True, op, fill)
        rounds += 1
        changed = not torch.equal(new, val)
        val = new
        if not changed or 0 < max_iters <= rounds:
            return val


def speckle_labels(disp: torch.Tensor, max_diff: float, max_iters: int = 0,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """4-connected component labels of (..., H, W) disparity maps, int32:
    two pixels link when both are valid and their disparities differ by at
    most ``max_diff``; a component's label is its smallest flat index
    y*W + x, an invalid pixel's is H*W. ``valid`` defaults to disp >= 0.

    Rounds of row sweeps (both directions) then column sweeps run until no
    label changes, or at most ``max_iters`` rounds when that is > 0 (capped
    labels can only over-split a component). The plain version of the
    union-find labels kernel (converged) and of the sweep kernel's labels
    mode (csrc/sweep.cu, capped or not)."""
    H, W = disp.shape[-2], disp.shape[-1]
    n = H * W
    if valid is None:
        valid = disp >= 0
    flat = torch.arange(n, dtype=torch.int32,
                        device=disp.device).reshape(H, W)
    sent = torch.full_like(flat, n)
    lab = torch.where(valid, flat, sent)
    ok_h = (valid[..., :, 1:] & valid[..., :, :-1]
            & ((disp[..., :, 1:] - disp[..., :, :-1]).abs() <= max_diff))
    ok_v = (valid[..., 1:, :] & valid[..., :-1, :]
            & ((disp[..., 1:, :] - disp[..., :-1, :]).abs() <= max_diff))
    c_h = torch.cat([torch.zeros_like(ok_h[..., :1]), ok_h], dim=-1)
    c_v = torch.cat([torch.zeros_like(ok_v[..., :1, :]), ok_v], dim=-2)
    lab = _sweep_rounds(lab, c_h, c_v, max_iters)
    return torch.where(valid, lab, sent)


def propagate_keep(labels: torch.Tensor, seed: torch.Tensor,
                   max_iters: int = 0) -> torch.Tensor:
    """(..., H, W) int32 labels and seeds -> int32: each seed's max spread
    over the 4-connected runs of equal labels other than the sentinel H*W,
    by the rounds of ``speckle_labels`` with max in place of min; until
    nothing changes, or at most ``max_iters`` rounds when that is > 0. The
    plain version of the TPU's ``_propagate_keep_kernel`` and of the sweep
    kernel's propagate mode (csrc/sweep.cu)."""
    H, W = labels.shape[-2], labels.shape[-1]
    ok = labels != H * W
    c_h = torch.cat([torch.zeros_like(ok[..., :1]),
                     ok[..., 1:] & (labels[..., 1:] == labels[..., :-1])],
                    dim=-1)
    c_v = torch.cat([torch.zeros_like(ok[..., :1, :]),
                     ok[..., 1:, :] & (labels[..., 1:, :]
                                       == labels[..., :-1, :])], dim=-2)
    return _sweep_rounds(seed, c_h, c_v, max_iters, torch.maximum, 0)


def speckle_keep_seeded(labels: torch.Tensor, max_size: int,
                        max_iters: int = 0, sorted_labels=sort.sorted_labels,
                        large_run_roots=sort.large_run_roots,
                        propagate=propagate_keep) -> torch.Tensor:
    """(B, H, W) int32 labels -> bool, component size > max_size, False
    for the sentinel: the TPU's seeded keep. The labels are sorted, the
    values of the runs longer than max_size (the large components' roots,
    for converged labels) seed their pixels, and ``propagate`` spreads the
    seeds over each component. The three steps default to the plain
    versions; ops/sgbm_cuda.py passes the kernels' wrappers."""
    B, H, W = labels.shape
    skey, n, n2, L, _ = sorted_labels(labels)
    roots = large_run_roots(skey, n2, L, max_size).reshape(B, -1)
    tgt = torch.where((roots >= 0) & (roots < n), roots,
                      torch.full_like(roots, n2)).to(torch.int64)
    seed = torch.zeros((B, n2 + 1), dtype=torch.int32, device=labels.device)
    seed.scatter_(1, tgt, 1)
    return propagate(labels, seed[:, :n].reshape(B, H, W).contiguous(),
                     max_iters) != 0


def _keep_mask(labels: torch.Tensor, max_size: int) -> torch.Tensor:
    """Valid pixels (label < H*W) of components larger than max_size: an
    int32 histogram of the labels (scatter_add_ of ones into H*W+1 bins
    per frame), then a gather."""
    H, W = labels.shape[-2], labels.shape[-1]
    n = H * W
    lab = labels.reshape(-1, n).to(torch.int64)
    sizes = torch.zeros((lab.shape[0], n + 1), dtype=torch.int32,
                        device=labels.device)
    sizes.scatter_add_(1, lab, torch.ones_like(lab, dtype=torch.int32))
    keep = (lab < n) & (torch.gather(sizes, 1, lab) > max_size)
    return keep.reshape(labels.shape)


def speckle_keep(disp: torch.Tensor, labels: torch.Tensor,
                 max_size: int) -> torch.Tensor:
    """``disp`` where the pixel is valid and its component has more than
    ``max_size`` pixels, else -1.0: the plain version of the keep kernel."""
    return torch.where(_keep_mask(labels, max_size), disp,
                       torch.full_like(disp, -1.0))


def speckle_filter(disp: torch.Tensor, valid: torch.Tensor, max_size: int,
                   max_diff: float, max_iters: int = 0) -> torch.Tensor:
    """Connected-component speckle removal (cv::filterSpeckles semantics):
    ``valid`` without the components of at most ``max_size`` pixels."""
    labels = speckle_labels(disp, max_diff, max_iters, valid=valid)
    return _keep_mask(labels, max_size)


def sgbm(left: torch.Tensor, right: torch.Tensor,
         params: SGBMParams = SGBMParams(),
         apply_lr: bool = True, apply_speckle: bool = True) -> torch.Tensor:
    """Full SGBM on (..., H, W) images -> float32 disparity, invalid -1.0:
    WTA, then the LR check, then the speckle filter."""
    cap = params.pre_filter_cap
    C = cost_volume(sobel_clip(left, cap), sobel_clip(right, cap), params)
    S = aggregate_paths(C, params.P1, params.P2, params.num_paths)
    disp, valid = wta(S, params)
    if apply_lr:
        valid = lr_check(S, disp, valid, params)
    if apply_speckle and params.speckle_window_size > 0:
        valid = speckle_filter(disp, valid, params.speckle_window_size,
                               params.speckle_range)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def compute_disparity_pair(left: torch.Tensor, right: torch.Tensor,
                           params: SGBMParams = SGBMParams()
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left and right disparity maps of (..., H, W) pairs: the right
    matcher is the left matcher on mirrored, swapped inputs
    (cv::ximgproc::createRightMatcher), so right-view disparities come
    out positive."""
    disp_l = sgbm(left, right, params)
    disp_r = sgbm(right.flip(-1), left.flip(-1), params).flip(-1)
    return disp_l, disp_r


def sgbm_pair(left: torch.Tensor, right: torch.Tensor,
              params: SGBMParams = SGBMParams()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``compute_disparity_pair`` from one cost build: Sobel, then
    ``cost_volume_pair``, the path sums of both volumes, the WTA/LR (the
    mirrored form for the right view) and the speckle filter on both maps.
    The plain counterpart of the JAX package's ``sgbm_pair_pallas``."""
    cap = params.pre_filter_cap
    vols = cost_volume_pair(sobel_clip(left, cap), sobel_clip(right, cap),
                            params)
    out = []
    for C, mirror in zip(vols, (False, True)):
        S = aggregate_paths(C, params.P1, params.P2, params.num_paths)
        disp = wta_lr(S, params, mirror_lr=mirror)
        if params.speckle_window_size > 0:
            disp = speckle_keep(disp, speckle_labels(disp,
                                                     params.speckle_range),
                                params.speckle_window_size)
        out.append(disp)
    return out[0], out[1]


def down_dirs(num_paths: int):
    """The down-going path directions of the staged chain: the vertical
    one, with its two diagonals when there are 8 paths."""
    return [(1, 0), (1, 1), (1, -1)] if num_paths == 8 else [(1, 0)]


def up_dirs(num_paths: int):
    """The up-going counterpart of ``down_dirs``."""
    return [(-dy, dx) for dy, dx in down_dirs(num_paths)]


def _sum_passes(C: torch.Tensor, dirs, params: SGBMParams) -> torch.Tensor:
    S = torch.zeros_like(C)
    for dy, dx in dirs:
        S += directional_pass(C, dy, dx, float(params.P1), float(params.P2))
    return S


def cost_down(lt: torch.Tensor, rt: torch.Tensor, params: SGBMParams
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, S_down3) of Sobel-clipped (..., H, W) images, both
    (..., H, W, D) float32: ``cost_volume`` and the sum of the down-going
    passes over it (``down_dirs``: three with 8 paths, the vertical one
    alone otherwise). The plain version of the fused cost + down kernel
    (csrc/cost_down.cu)."""
    C = cost_volume(lt, rt, params)
    return C, _sum_passes(C, down_dirs(params.num_paths), params)


def wta_lr3(S_down: torch.Tensor, S_up: torch.Tensor, S_h: torch.Tensor,
            params: SGBMParams, apply_lr: bool = True) -> torch.Tensor:
    """``wta_lr`` on the sum of three partial path sums: the plain version
    of the three-input WTA/LR kernel (csrc/wta_lr.cu)."""
    S = (S_down.to(torch.float32) + S_up.to(torch.float32)
         + S_h.to(torch.float32))
    return wta_lr(S, params, apply_lr)


def transpose_vol(x: torch.Tensor) -> torch.Tensor:
    """(A, D, B) -> (B, D, A), bits unchanged."""
    return x.permute(2, 1, 0).contiguous()


def transpose_leading(x: torch.Tensor) -> torch.Tensor:
    """(A, B, W) -> (B, A, W), bits unchanged."""
    return x.permute(1, 0, 2).contiguous()


def transpose_dhw_to_wdh(x: torch.Tensor) -> torch.Tensor:
    """(D, H, W) -> (W, D, H), bits unchanged."""
    return x.permute(2, 0, 1).contiguous()


def sgbm_staged(left: torch.Tensor, right: torch.Tensor,
                params: SGBMParams = SGBMParams(), apply_lr: bool = True,
                apply_speckle: bool = True) -> torch.Tensor:
    """``sgbm`` by the staged chain: Sobel, ``cost_down``, the horizontal
    sum, the up-going sum, ``wta_lr3``, then the speckle filter. Needs 4
    or 8 paths; equal to ``sgbm`` bit for bit (integer path values)."""
    if params.num_paths < 4:
        raise ValueError("the staged chain needs 4 or 8 paths, got "
                         f"{params.num_paths}")
    cap = params.pre_filter_cap
    C, S_down = cost_down(sobel_clip(left, cap), sobel_clip(right, cap),
                          params)
    S_h = _sum_passes(C, [(0, 1), (0, -1)], params)
    S_up = _sum_passes(C, up_dirs(params.num_paths), params)
    disp = wta_lr3(S_down, S_up, S_h, params, apply_lr)
    if apply_speckle and params.speckle_window_size > 0:
        disp = speckle_keep(disp, speckle_labels(disp, params.speckle_range),
                            params.speckle_window_size)
    return disp
