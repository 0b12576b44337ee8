# Frozen copy of the plain WLS filter of stereo_depth_ruler_tpu_torch/ops/wls.py (shift_gather_conf, thomas_solve, fgs_filter), with a dtype argument.
"""The confidence-weighted WLS disparity filter (Fast Global Smoother) in
plain PyTorch, as cv::ximgproc's DisparityWLSFilter with the right
matcher: the LR confidence (1 where the left disparity is valid and the
right view's disparity at x - round(dl) agrees within ``lrc_thresh``),
then 3 iterations of row and column solves of (I + lam_t A_w) u = f with
w = exp(-|d guide| / sigma) on the stack (conf * max(dl, 0), conf), and
their ratio, -1.0 where the smoothed confidence is at most 1e-3.

Each tridiagonal solve is the Thomas recurrence run from both ends of a
line towards its middle; every step is rounded on its own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

GATHER_FILL = -1e9


def lambdas(lam: float, iters: int):
    """lam_t of each iteration, rounded to float32."""
    denom = 4.0 ** iters - 1.0
    return [float(np.float32(1.5 * lam * (4.0 ** (iters - t - 1)) / denom))
            for t in range(iters)]


def confidence_rhs(dl: torch.Tensor, dr: torch.Tensor, max_disp: int,
                   lrc_thresh: float) -> torch.Tensor:
    """(..., H, W) disparities -> (..., 2, H, W) (conf * max(dl, 0), conf)."""
    W = dl.shape[-1]
    xs = torch.arange(W, dtype=dl.dtype, device=dl.device)
    s = (xs - torch.round(xs - dl)).to(torch.int32)
    src = torch.arange(W, device=dl.device) - s.to(torch.int64)
    ok = (s >= 0) & (s <= max_disp) & (src >= 0)
    got = torch.gather(dr, -1, src.clamp(0, W - 1))
    drs = torch.where(ok, got, torch.full_like(got, GATHER_FILL))
    consistent = ((drs - dl).abs() <= lrc_thresh) & (drs >= 0)
    conf = ((dl >= 0) & consistent).to(dl.dtype)
    return torch.stack([conf * dl.clamp_min(0.0), conf], dim=-3)


def _thomas(a, b, c, d):
    N = d.shape[-1]
    m = N // 2
    zc = torch.zeros_like(b[..., 0])
    zd = torch.zeros_like(d[..., 0])

    def recip(x):
        return torch.ones_like(x) / x

    ct, pt, top = zc, zd, []
    for i in range(m):
        ai = a[..., i]
        r = recip(b[..., i] - ai * ct)
        ct, pt = c[..., i] * r, (d[..., i] - ai * pt) * r
        top.append((ct, pt))
    cb, pb, bottom = zc, zd, {}
    for i in range(N - 1, m, -1):
        ci = c[..., i]
        r = recip(b[..., i] - ci * cb)
        cb, pb = a[..., i] * r, (d[..., i] - ci * pb) * r
        bottom[i] = (cb, pb)
    am, cm = a[..., m], c[..., m]
    x = [None] * N
    x[m] = (((d[..., m] - am * pt) - cm * pb)
            * recip((b[..., m] - am * ct) - cm * cb))
    for i in range(m - 1, -1, -1):
        x[i] = top[i][1] - top[i][0] * x[i + 1]
    for i in range(m + 1, N):
        x[i] = bottom[i][1] - bottom[i][0] * x[i - 1]
    return torch.stack(x, dim=-1)


def _solve_rows(u: torch.Tensor, g: torch.Tensor, lam: float, sigma: float
                ) -> torch.Tensor:
    diff = (g[..., 1:] - g[..., :-1]).abs()
    w = torch.exp(-diff / torch.full_like(diff, sigma))
    zero = w.new_zeros(w.shape[:-1] + (1,))
    w_r = torch.cat([w, zero], dim=-1)
    w_l = torch.cat([zero, w], dim=-1)
    return _thomas(-lam * w_l, 1.0 + lam * (w_l + w_r), -lam * w_r, u)


def smooth(u: torch.Tensor, guide: torch.Tensor, lam: float, sigma: float,
           iters: int) -> torch.Tensor:
    """The FGS of the (..., R, H, W) stack under the (..., H, W) guide."""
    g = guide.contiguous().unsqueeze(-3)
    for lam_t in lambdas(lam, iters):
        u = _solve_rows(u, g, lam_t, sigma)
        u = _solve_rows(u.transpose(-1, -2), g.transpose(-1, -2), lam_t,
                        sigma).transpose(-1, -2)
    return u


def wls(dl: torch.Tensor, dr: torch.Tensor, guide: torch.Tensor,
        max_disp: int, p: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(filtered disparity, confidence); ``p`` holds the configuration's
    ``wls`` block. Computed in the dtype of ``dl``."""
    rhs = confidence_rhs(dl, dr, max_disp, p["lrc_thresh"])
    u = smooth(rhs, guide.to(dl.dtype), p["lambda"], p["sigma"], p["iters"])
    num, den = u.unbind(-3)
    disp = torch.where(den > 1e-3, num / den.clamp_min(1e-6),
                       torch.full_like(num, -1.0))
    return disp, rhs.select(-3, 1)
