"""Edge-preserving WLS disparity filter (Fast Global Smoother) in plain
PyTorch — the plain versions of the FGS-pass and shift-gather kernels.

Port of ``stereo_depth_ruler_tpu/ops/wls.py``: each FGS iteration solves
the tridiagonal systems (I + λ_t A_w) u = f along rows, then along
columns, with weights w = exp(-|Δguide| / σ); λ_t = 1.5 λ 4^(T-t-1) /
(4^T - 1). The confidence-weighted filter solves the stacked right-hand
sides (conf·disp, conf) and divides, so low-confidence pixels are inpainted.

The JAX package solves the systems by parallel cyclic reduction with one
refinement step (``tridiag_solve`` here is its counterpart), which suits a
TPU's elementwise rounds. The sweep ``fgs_pass`` instead runs the
sequential Thomas recurrence (``thomas_solve``), from both ends of a line
towards its middle, which is how a GPU solves many independent lines: a
few threads per line, each a chain of N / 2 steps. The systems are
strictly diagonally dominant, so it needs neither pivoting nor
refinement. The two
solves differ in the last bits; the filter stays within the JAX package's
WLS bound of its jnp and Pallas filters (tests/test_torch_wls.py).

Shapes carry a batch: right-hand sides (..., R, H, W) with one guide
(..., H, W) for the R planes. The LR confidence gathers the right view
with ``shift_gather``, the contract of the TPU shift-gather kernel, which
gives the jnp reference's take-along-axis values bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["tridiag_solve", "thomas_solve", "fgs_filter", "fgs_pass", "shift_gather",
           "shift_gather_conf", "filtered_disparity", "wls_disparity_filter",
           "fgs_lambdas"]

GATHER_FILL = -1e9   # fails both the |dr - dl| and the dr >= 0 tests


def _shift_last(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x[..., i-s] for s > 0 / x[..., i+|s|] for s < 0, out of range =
    fill."""
    pad = torch.full(x.shape[:-1] + (abs(s),), fill, dtype=x.dtype,
                     device=x.device)
    if s > 0:
        return torch.cat([pad, x[..., :-s]], dim=-1)
    return torch.cat([x[..., -s:], pad], dim=-1)


def _tridiag_solve_pcr(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       d: torch.Tensor) -> torch.Tensor:
    """Parallel cyclic reduction along the last axis: each round removes
    the couplings at distance s; after ceil(log2 N) rounds the system is
    diagonal."""
    N = a.shape[-1]
    s = 1
    while s < N:
        bm = _shift_last(b, s, 1.0)
        bp = _shift_last(b, -s, 1.0)
        alpha = -a / bm
        gamma = -c / bp
        b = (b + alpha * _shift_last(c, s, 0.0)
             + gamma * _shift_last(a, -s, 0.0))
        d = (d + alpha * _shift_last(d, s, 0.0)
             + gamma * _shift_last(d, -s, 0.0))
        a = alpha * _shift_last(a, s, 0.0)
        c = gamma * _shift_last(c, -s, 0.0)
        s *= 2
    return d / b


def tridiag_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  d: torch.Tensor, refine: int = 1) -> torch.Tensor:
    """Solve tridiagonal systems along the last axis, batched: a sub-,
    b main, c super-diagonal (a[..., 0] and c[..., -1] are ignored), d the
    right-hand side; a, b, c broadcast against d. Needs diagonal dominance
    (true of the FGS systems); ``refine`` refinement steps polish the
    float32 residual."""
    a = a.clone()
    a[..., 0] = 0.0
    c = c.clone()
    c[..., -1] = 0.0
    u = _tridiag_solve_pcr(a, b, c, d)
    for _ in range(refine):
        u_m = _shift_last(u, 1, 0.0)
        u_p = _shift_last(u, -1, 0.0)
        r = d - (a * u_m + b * u + c * u_p)
        u = u + _tridiag_solve_pcr(a, b, c, r)
    return u


def thomas_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    """Solve tridiagonal systems along the last axis by the Thomas
    recurrence run from both ends towards the middle element m = N // 2
    (a twisted factorization): a sub-, b main, c super-diagonal (a[..., 0]
    and c[..., -1] are not read), d the right-hand side; a, b, c broadcast
    against d and are eliminated once for all of d's planes. Needs diagonal
    dominance (true of the FGS systems).

    Top, i = 0 .. m-1:  r = 1 / (b - a c'),   c' = c r,  d' = (d - a d') r.
    Bottom, i = N-1 .. m+1:  r = 1 / (b - c a''),  a'' = a r,
    d'' = (d - c d'') r.  Then x[m] = ((d - a d') - c d'') / ((b - a c')
    - c a'') at m, and x[i] = d'[i] - c'[i] x[i+1] below it, x[i] =
    d''[i] - a''[i] x[i-1] above. Each half is a sequential chain of N / 2
    steps: the FGS-pass kernel runs the two halves on two threads. The
    plain version of the kernel's solve: every product and difference is
    rounded on its own and each reciprocal is an IEEE division of a tensor
    of ones, as the kernel does."""
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


def _fgs_pass_lastaxis(u: torch.Tensor, guide: torch.Tensor, lam: float,
                       sigma: float) -> torch.Tensor:
    """One FGS sweep with the systems along the last axis."""
    diff = (guide[..., 1:] - guide[..., :-1]).abs()
    # a tensor divisor: PyTorch's CUDA division by a Python scalar is a
    # multiplication by its reciprocal, not IEEE division
    w = torch.exp(-diff / torch.full_like(diff, sigma))  # weight i to i+1
    zero = w.new_zeros(w.shape[:-1] + (1,))   # also for a 1-element line
    w_r = torch.cat([w, zero], dim=-1)
    w_l = torch.cat([zero, w], dim=-1)
    a = -lam * w_l
    c = -lam * w_r
    b = 1.0 + lam * (w_l + w_r)
    return thomas_solve(a, b, c, u)


def fgs_pass(u: torch.Tensor, guide: torch.Tensor, lam: float, sigma: float,
             axis: int) -> torch.Tensor:
    """One FGS sweep of the (..., R, H, W) right-hand sides under the
    (..., H, W) guide, along rows (axis -1) or columns (axis -2), by
    ``thomas_solve``: the plain version of the FGS-pass kernel."""
    g = guide.unsqueeze(-3) if guide.dim() < u.dim() else guide
    if axis == -1:
        return _fgs_pass_lastaxis(u, g, lam, sigma)
    if axis == -2:
        return _fgs_pass_lastaxis(u.transpose(-1, -2), g.transpose(-1, -2),
                                  lam, sigma).transpose(-1, -2)
    raise ValueError(f"axis must be -1 or -2, got {axis}")


def fgs_lambdas(lam: float, num_iters: int):
    """λ_t of each iteration, rounded to float32 as the JAX package does."""
    denom = 4.0 ** num_iters - 1.0
    return [float(np.float32(1.5 * lam * (4.0 ** (num_iters - t - 1))
                             / denom)) for t in range(num_iters)]


def fgs_filter(src: torch.Tensor, guide: torch.Tensor, lam: float = 8000.0,
               sigma_color: float = 1.1, num_iters: int = 3,
               sweep: Callable = fgs_pass) -> torch.Tensor:
    """Fast Global Smoother of ``src`` (..., H, W), or of a stack
    (..., R, H, W) sharing one guide (..., H, W); λ and σ default to the
    reference's WLS settings. ``sweep`` runs one pass: this module's plain
    ``fgs_pass``, or the kernel's wrapper (``ops/wls_cuda.py``)."""
    u = src.to(torch.float32)
    g = guide.to(torch.float32).contiguous()
    for lam_t in fgs_lambdas(lam, num_iters):
        u = sweep(u, g, lam_t, sigma_color, -1)
        u = sweep(u, g, lam_t, sigma_color, -2)
    return u


def shift_gather(values: torch.Tensor, shift: torch.Tensor, max_shift: int,
                 fill: float) -> torch.Tensor:
    """out[..., y, x] = values[..., y, x - s] with s = shift[..., y, x];
    ``fill`` where s is outside [0, max_shift] or x - s < 0."""
    W = values.shape[-1]
    src = torch.arange(W, device=values.device) - shift.to(torch.int64)
    ok = (shift >= 0) & (shift <= max_shift) & (src >= 0)
    got = torch.gather(values, -1, src.clamp(0, W - 1))
    return torch.where(ok, got, torch.full_like(got, fill))


def shift_gather_conf(disp_left: torch.Tensor, disp_right: torch.Tensor,
                      max_disp: int, lrc_thresh: float = 24.0 / 16.0
                      ) -> torch.Tensor:
    """LR confidence and the stacked right-hand sides of the WLS solve:
    (..., H, W) disparities -> (..., 2, H, W) = (conf·max(dl, 0), conf),
    conf = 1 where dl is valid and the right view's disparity at
    x - round(dl) agrees within ``lrc_thresh``. The plain version of the
    shift-gather kernel; ``max_disp`` bounds the shift."""
    W = disp_left.shape[-1]
    xs = torch.arange(W, dtype=torch.float32, device=disp_left.device)
    # s = x - round(x - dl), not round(dl): round is half to even, and the
    # parity of x - dl differs from that of dl
    s = (xs - torch.round(xs - disp_left)).to(torch.int32)
    dr = shift_gather(disp_right, s, max_disp, GATHER_FILL)
    consistent = ((dr - disp_left).abs() <= lrc_thresh) & (dr >= 0)
    conf = ((disp_left >= 0) & consistent).to(torch.float32)
    return torch.stack([conf * disp_left.clamp_min(0.0), conf], dim=-3)


def filtered_disparity(u: torch.Tensor) -> torch.Tensor:
    """(..., 2, H, W) smoothed (conf·disp, conf) -> their ratio, -1.0 where
    the smoothed confidence is at most 1e-3."""
    num, den = u.unbind(-3)
    return torch.where(den > 1e-3, num / den.clamp_min(1e-6),
                       torch.full_like(num, -1.0))


def wls_disparity_filter(disp_left: torch.Tensor, disp_right: torch.Tensor,
                         guide: torch.Tensor, lam: float = 8000.0,
                         sigma_color: float = 1.1,
                         lrc_thresh: float = 24.0 / 16.0, num_iters: int = 3,
                         max_disp: Optional[int] = None,
                         gather: Callable = shift_gather_conf,
                         sweep: Callable = fgs_pass
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Confidence-weighted WLS filtering of (..., H, W) left/right
    disparities guided by the left image: FGS(conf·disp) / FGS(conf), -1.0
    where the smoothed confidence is at most 1e-3. Returns (filtered,
    confidence). ``max_disp`` defaults to W - 1, which gathers every
    in-range partner. ``gather`` and ``sweep`` are this module's plain
    ``shift_gather_conf`` and ``fgs_pass``, or the kernels' wrappers
    (``ops/wls_cuda.py``)."""
    if max_disp is None:
        max_disp = disp_left.shape[-1] - 1
    rhs = gather(disp_left, disp_right, max_disp, lrc_thresh)
    u = fgs_filter(rhs, guide, lam, sigma_color, num_iters, sweep)
    return filtered_disparity(u), rhs.select(-3, 1)
