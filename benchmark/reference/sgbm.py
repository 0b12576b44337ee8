# Frozen copy of the plain matcher of stereo_depth_ruler_tpu_torch/ops/sgbm.py (itself held to ops/sgbm_ref.py's NumPy oracle).
"""Semi-global block matching in plain PyTorch, OpenCV StereoSGBM
semantics (MODE_SGBM_3WAY's cost with 2, 4 or 8 paths):

- cost: x-Sobel of the integer image clipped to [0, 2 cap],
  Birchfield-Tomasi (doubled, so integral) over D disparities, the right
  column clamped to the border, summed over block x block windows;
- aggregation: L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d +- 1) +
  P1, min L_r(p-r) + P2) - min L_r(p-r), a path entering at the border
  with L = C; S is the sum over the paths;
- winner-take-all with the uniqueness ratio, the parabola's subpixel
  offset quantised to 1/16, invalid where d > x;
- the left-right check against the right-view disparity scattered from
  the per-column winners (lower cost wins, ties the smaller d);
- the speckle filter: 4-connected components whose neighbouring
  disparities differ by at most ``speckle_range``; those of at most
  ``speckle_window_size`` pixels are invalid.

Every value is a small integer held in float32, so the result is exact.
Invalid disparities are -1.0. Shapes carry leading batch dimensions.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e9
_BIGI = 2 ** 28


def _pad_edge(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    if r == 0:
        return x
    shape = list(x.shape)
    shape[dim] = r
    lo = x.narrow(dim, 0, 1).expand(shape)
    hi = x.narrow(dim, x.shape[dim] - 1, 1).expand(shape)
    return torch.cat([lo, x, hi], dim=dim)


def sobel_clip(img: torch.Tensor, cap: int) -> torch.Tensor:
    """3x3 x-Sobel of the image truncated to integers, clipped to
    [0, 2 cap], replicate border."""
    img = img.to(torch.int32).to(torch.float32)
    p = _pad_edge(_pad_edge(img, -2, 1), -1, 1)
    gx = (2.0 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
          + (p[..., :-2, 2:] - p[..., :-2, :-2])
          + (p[..., 2:, 2:] - p[..., 2:, :-2]))
    return torch.clamp(gx, -cap, cap) + cap


def _bt_minmax(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    vm = torch.cat([v[..., :1], 0.5 * (v[..., 1:] + v[..., :-1])], dim=-1)
    vp = torch.cat([0.5 * (v[..., :-1] + v[..., 1:]), v[..., -1:]], dim=-1)
    return (torch.minimum(torch.minimum(vm, vp), v),
            torch.maximum(torch.maximum(vm, vp), v))


def cost_volume(lt: torch.Tensor, rt: torch.Tensor, D: int, md: int,
                block: int) -> torch.Tensor:
    """Boxed BT cost (..., H, W, D) of Sobel-clipped images."""
    W = lt.shape[-1]
    lmin, lmax = _bt_minmax(lt)
    rmin, rmax = _bt_minmax(rt)
    xs = torch.arange(W, device=lt.device)[:, None]
    ds = torch.arange(D, device=lt.device)[None, :] + md
    xr = torch.clamp(xs - ds, 0, W - 1)

    def gather(a):
        return a[..., xr]

    lv = lt[..., None]
    rv = gather(rt)
    zero = torch.zeros((), dtype=lt.dtype, device=lt.device)
    c_lr = torch.maximum(zero, torch.maximum(lv - gather(rmax),
                                             gather(rmin) - lv))
    c_rl = torch.maximum(zero, torch.maximum(rv - lmax[..., None],
                                             lmin[..., None] - rv))
    C = 2.0 * torch.minimum(c_lr, c_rl)
    r = block // 2
    H = C.shape[-3]
    p = _pad_edge(C, -3, r)
    C = sum(p[..., dy:dy + H, :, :] for dy in range(block))
    p = _pad_edge(C, -2, r)
    return sum(p[..., dx:dx + W, :] for dx in range(block))


def _dp_update(Lp: torch.Tensor, c: torch.Tensor, P1: float, P2: float
               ) -> torch.Tensor:
    minL = Lp.amin(dim=-1, keepdim=True)
    big = torch.full_like(Lp[..., :1], _BIG)
    lm1 = torch.cat([big, Lp[..., :-1]], dim=-1)
    lp1 = torch.cat([Lp[..., 1:], big], dim=-1)
    best = torch.minimum(torch.minimum(Lp, minL + P2),
                         torch.minimum(lm1, lp1) + P1)
    return c + best - minL


def _path(C: torch.Tensor, dy: int, dx: int, P1: float, P2: float
          ) -> torch.Tensor:
    """L_r over (..., H, W, D) for r = (dy, dx): a horizontal path scans W,
    every other one scans H with its carry shifted by dx each row."""
    if dy == 0:
        cw = C.movedim(-2, 0)
        order = range(cw.shape[0]) if dx > 0 else range(cw.shape[0] - 1,
                                                        -1, -1)
        carry = torch.zeros_like(cw[0])
        out = [None] * cw.shape[0]
        for x in order:
            carry = _dp_update(carry, cw[x], P1, P2)
            out[x] = carry
        return torch.stack(out, dim=0).movedim(0, -2)
    ch = C.movedim(-3, 0)
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


PATHS = {8: [(0, 1), (0, -1), (1, 0), (-1, 0),
             (1, 1), (1, -1), (-1, 1), (-1, -1)],
         4: [(0, 1), (0, -1), (1, 0), (-1, 0)],
         2: [(0, 1), (0, -1)]}


def aggregate(C: torch.Tensor, P1: float, P2: float, paths: int
              ) -> torch.Tensor:
    S = torch.zeros_like(C)
    for dy, dx in PATHS[paths]:
        S += _path(C, dy, dx, float(P1), float(P2))
    return S


def wta(S: torch.Tensor, p: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(disp, valid): winner, uniqueness, subpixel, d <= x."""
    D, W = S.shape[-1], S.shape[-2]
    d_star = torch.argmin(S, dim=-1)
    s0 = S.amin(dim=-1)
    valid = torch.ones_like(s0, dtype=torch.bool)
    if p["uniqueness_ratio"] > 0:
        thresh = s0 * ((100 + p["uniqueness_ratio"]) / 100.0)
        far = (torch.arange(D, device=S.device) - d_star[..., None]).abs() > 1
        valid &= ~((S < thresh[..., None]) & far).any(dim=-1)
    dm = torch.clamp(d_star - 1, 0, D - 1)
    dp = torch.clamp(d_star + 1, 0, D - 1)
    sm = torch.gather(S, -1, dm[..., None])[..., 0]
    sp = torch.gather(S, -1, dp[..., None])[..., 0]
    denom = torch.clamp(sm + sp - 2.0 * s0, min=1e-6)
    offset = torch.clamp((sm - sp) / (2.0 * denom), -0.5, 0.5)
    offset = torch.where((d_star == 0) | (d_star == D - 1),
                         torch.zeros_like(offset), offset)
    disp = (d_star.to(torch.float32) + offset) + p["min_disparity"]
    if p["quantize_16"]:
        disp = torch.round(disp * 16.0) / 16.0
    valid &= (d_star + p["min_disparity"]) <= torch.arange(W, device=S.device)
    return disp.to(torch.float32), valid


def _disp2(s0i: torch.Tensor, d_star: torch.Tensor, D: int, md: int
           ) -> torch.Tensor:
    """The right-view disparity from the per-column winners: the winner of
    column x lands at x - d* - md, the lower cost (then the smaller d)
    wins; -1 where none lands."""
    W = s0i.shape[-1]
    PK = 1 << int(D + md).bit_length()
    BIGP = 2 ** 30
    packed = s0i * PK + d_star + md
    best = torch.full_like(packed, BIGP)
    for d in range(D):
        s = d + md
        if s >= W:
            break
        cand = packed
        if s:
            cand = torch.cat([packed[..., s:],
                              torch.full_like(packed[..., :s], BIGP)], dim=-1)
        hit = (cand & (PK - 1)) == s
        best = torch.minimum(best, torch.where(hit, cand,
                                               torch.full_like(cand, BIGP)))
    return torch.where(best < BIGP, (best & (PK - 1)).to(torch.float32),
                       torch.full_like(best, -1, dtype=torch.float32))


def lr_check(S: torch.Tensor, disp: torch.Tensor, valid: torch.Tensor,
             p: dict) -> torch.Tensor:
    if p["disp12_max_diff"] < 0:
        return valid
    D, W = S.shape[-1], S.shape[-2]
    d_star = torch.argmin(S, dim=-1).to(torch.int32)
    s0i = S.amin(dim=-1).to(torch.int32)
    disp2 = _disp2(s0i, d_star, D, p["min_disparity"])
    xr = (torch.arange(W, device=S.device, dtype=torch.int32)
          - torch.round(disp).to(torch.int32))
    xr_ok = (xr >= 0) & (xr <= W - 1)
    d2 = torch.gather(disp2, -1, torch.clamp(xr, 0, W - 1).to(torch.int64))
    consistent = (d2 >= 0) & ((d2 - disp).abs() <= p["disp12_max_diff"])
    return valid & torch.where(xr_ok, consistent, torch.ones_like(xr_ok))


def _shift(x: torch.Tensor, k: int, dim: int, fill) -> torch.Tensor:
    n = x.shape[dim]
    if abs(k) >= n:
        return torch.full_like(x, fill)
    pad = torch.full_like(x.narrow(dim, 0, abs(k)), fill)
    if k > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - k)], dim=dim)
    return torch.cat([x.narrow(dim, -k, n + k), pad], dim=dim)


def _run_min(lab: torch.Tensor, conn: torch.Tensor, dim: int,
             reverse: bool) -> torch.Tensor:
    """The min of ``lab`` over each element's linked run up to it along
    ``dim`` (conn[i] links i to i - 1), by log-doubling."""
    n = lab.shape[dim]
    c = _shift(conn, -1, dim, False) if reverse else conn
    val = lab
    k = 1
    while k < n:
        step = -k if reverse else k
        v_n = _shift(val, step, dim, _BIGI)
        c_n = _shift(c, step, dim, False)
        val = torch.where(c, torch.minimum(val, v_n), val)
        c = c & c_n
        k *= 2
    return val


def speckle(disp: torch.Tensor, valid: torch.Tensor, max_size: int,
            max_diff: float) -> torch.Tensor:
    """``valid`` without the components of at most ``max_size`` pixels:
    labels (the smallest flat index of each component) by rounds of run
    minima along rows and columns until nothing changes, then a histogram."""
    H, W = disp.shape[-2], disp.shape[-1]
    n = H * W
    flat = torch.arange(n, dtype=torch.int32, device=disp.device).reshape(H, W)
    lab = torch.where(valid, flat, torch.full_like(flat, n))
    ok_h = (valid[..., :, 1:] & valid[..., :, :-1]
            & ((disp[..., :, 1:] - disp[..., :, :-1]).abs() <= max_diff))
    ok_v = (valid[..., 1:, :] & valid[..., :-1, :]
            & ((disp[..., 1:, :] - disp[..., :-1, :]).abs() <= max_diff))
    c_h = torch.cat([torch.zeros_like(ok_h[..., :1]), ok_h], dim=-1)
    c_v = torch.cat([torch.zeros_like(ok_v[..., :1, :]), ok_v], dim=-2)
    while True:
        new = _run_min(lab, c_h, -1, False)
        new = _run_min(new, c_h, -1, True)
        new = _run_min(new, c_v, -2, False)
        new = _run_min(new, c_v, -2, True)
        if torch.equal(new, lab):
            break
        lab = new
    lab = torch.where(valid, lab, torch.full_like(lab, n))
    flat_lab = lab.reshape(-1, n).to(torch.int64)
    sizes = torch.zeros((flat_lab.shape[0], n + 1), dtype=torch.int32,
                        device=disp.device)
    sizes.scatter_add_(1, flat_lab, torch.ones_like(flat_lab,
                                                    dtype=torch.int32))
    keep = (flat_lab < n) & (torch.gather(sizes, 1, flat_lab) > max_size)
    return keep.reshape(lab.shape)


def sgbm(left: torch.Tensor, right: torch.Tensor, p: dict) -> torch.Tensor:
    """(..., H, W) pair -> float32 disparity, -1.0 where invalid. ``p``
    holds the configuration's ``sgbm`` block."""
    cap = p["pre_filter_cap"]
    C = cost_volume(sobel_clip(left, cap), sobel_clip(right, cap),
                    p["num_disparities"], p["min_disparity"], p["block_size"])
    S = aggregate(C, p["p1"], p["p2"], p["num_paths"])
    del C
    disp, valid = wta(S, p)
    valid = lr_check(S, disp, valid, p)
    del S
    if p["speckle_window_size"] > 0:
        valid = speckle(disp, valid, p["speckle_window_size"],
                        p["speckle_range"])
    return torch.where(valid, disp, torch.full_like(disp, -1.0))
