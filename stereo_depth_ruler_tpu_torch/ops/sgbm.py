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

``speckle_filter`` is not ported yet: ``sgbm`` raises for a configuration
that turns it on.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams

__all__ = ["SGBMParams", "sobel_clip", "bt_cost_volume", "box_filter_volume",
           "cost_volume", "directional_pass", "aggregate_paths", "wta",
           "lr_check", "wta_lr", "sgbm", "SPECKLE_QUEUED"]

_BIG = 1e9

SPECKLE_QUEUED = (
    "the speckle filter is not ported yet: its kernels (the CCL labels "
    "kernel, the key-only sort, the large-roots and the propagate-keep "
    "kernels) are queued; set speckle_window_size=0")


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


def wta(S: torch.Tensor, params: SGBMParams
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all + uniqueness + subpixel -> (disp f32, valid bool),
    the rules of ``sgbm_ref.wta_np``. Ties go to the smallest d."""
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
    valid &= (d_star + params.min_disparity) <= xs
    return disp.to(torch.float32), valid


def _winner_scatter_disp2(s0i: torch.Tensor, d_star: torch.Tensor,
                          D: int, min_disp: int) -> torch.Tensor:
    """Right-view disparity from the per-column WTA winners (OpenCV's
    internal disp2): the winner (s0, d*) of column x lands at
    x - d* - min_disp; collisions keep the lower cost, ties the smaller d.
    D masked left-shifts of an int32 (cost, d)-packed map.

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
            cand = torch.cat([packed[..., s:], fill], dim=-1)
        okm = (cand & (PK - 1)) == s
        disp2p = torch.minimum(disp2p, torch.where(okm, cand,
                                                   torch.full_like(cand,
                                                                   BIGP)))
    return torch.where(disp2p < BIGP, (disp2p & (PK - 1)).to(torch.float32),
                       torch.full_like(disp2p, -1, dtype=torch.float32))


def lr_check(S: torch.Tensor, disp: torch.Tensor, valid: torch.Tensor,
             params: SGBMParams) -> torch.Tensor:
    """Consistency check against the right-view disparity built from the
    per-column WTA winners of the same volume (``sgbm_ref.lr_check_np``)."""
    if params.disp12_max_diff < 0:
        return valid
    D, W = S.shape[-1], S.shape[-2]
    d_star = torch.argmin(S, dim=-1).to(torch.int32)
    s0i = S.amin(dim=-1).to(torch.int32)            # exact small ints
    disp2 = _winner_scatter_disp2(s0i, d_star, D, params.min_disparity)
    xr = (torch.arange(W, device=S.device, dtype=torch.int32)
          - torch.round(disp).to(torch.int32))
    xr_ok = (xr >= 0) & (xr <= W - 1)
    d2 = torch.gather(disp2, -1, torch.clamp(xr, 0, W - 1).to(torch.int64))
    consistent = (d2 >= 0) & ((d2 - disp).abs() <= params.disp12_max_diff)
    return valid & torch.where(xr_ok, consistent, torch.ones_like(xr_ok))


def wta_lr(S: torch.Tensor, params: SGBMParams,
           apply_lr: bool = True) -> torch.Tensor:
    """wta, then lr_check, then -1.0 where invalid: the plain version of
    the WTA/LR kernel (csrc/wta_lr.cu)."""
    disp, valid = wta(S, params)
    if apply_lr:
        valid = lr_check(S, disp, valid, params)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def sgbm(left: torch.Tensor, right: torch.Tensor,
         params: SGBMParams = SGBMParams(),
         apply_lr: bool = True, apply_speckle: bool = True) -> torch.Tensor:
    """Full SGBM on (..., H, W) images -> float32 disparity, invalid -1.0.

    Raises NotImplementedError when the speckle filter would run."""
    if apply_speckle and params.speckle_window_size > 0:
        raise NotImplementedError(SPECKLE_QUEUED)
    cap = params.pre_filter_cap
    C = cost_volume(sobel_clip(left, cap), sobel_clip(right, cap), params)
    S = aggregate_paths(C, params.P1, params.P2, params.num_paths)
    return wta_lr(S, params, apply_lr)
