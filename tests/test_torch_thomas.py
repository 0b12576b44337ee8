"""The FGS sweep's Thomas solve, run from both ends of a line towards its
middle (``ops/wls.py:thomas_solve``, the plain version of the FGS-pass
kernel), against a float64 NumPy solve of the same systems, and the filter
built on it against the JAX package's jnp filter and its Pallas filter in
interpret mode.

The JAX package solves the systems by parallel cyclic reduction with one
refinement step; Thomas is another algorithm, so the filter is held to the
JAX package's own WLS bound (rtol 2e-3, atol 2e-2, the bound of
tests/test_torch_wls.py), not bitwise. The guides include a step edge,
where the weights fall to exp(-28 / 1.1) ~ 9e-12 across one edge and to
exp(-255 / 1.1) ~ 1e-101 (zero in float32) across the other, and lines of
1, 2 and 3 pixels.
The JAX filter cannot take a line of one pixel (its solve indexes element
0 of an empty weight row), so there the float64 filter is the reference."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.linalg import solve_banded

from stereo_depth_ruler_tpu.ops import wls as jw
from stereo_depth_ruler_tpu.ops import wls_pallas as wp
from stereo_depth_ruler_tpu_torch.ops import wls as tw
from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc

RTOL, ATOL = 2e-3, 2e-2


def T(a):
    return torch.tensor(np.asarray(a))


def fgs_systems(guide, lam, sigma):
    """The FGS coefficients (a, b, c) of the lines along the last axis of a
    float32 guide, in float64."""
    g = guide.astype(np.float64)
    w = np.exp(-np.abs(np.diff(g, axis=-1)) / sigma)
    zero = np.zeros(w.shape[:-1] + (1,))
    w_l = np.concatenate([zero, w], axis=-1)
    w_r = np.concatenate([w, zero], axis=-1)
    return -lam * w_l, 1.0 + lam * (w_l + w_r), -lam * w_r


def solve64(a, b, c, d):
    """float64 banded solve of every line along the last axis; a, b, c
    broadcast against d."""
    a, b, c = (np.broadcast_to(x, d.shape) for x in (a, b, c))
    N = d.shape[-1]
    out = np.empty(d.shape)
    for idx in np.ndindex(d.shape[:-1]):
        ab = np.zeros((3, N))
        ab[0, 1:] = c[idx][:-1]
        ab[1] = b[idx]
        ab[2, :-1] = a[idx][1:]
        out[idx] = solve_banded((1, 1), ab, d[idx])
    return out


def fgs64(src, guide, lam=8000.0, num_iters=3, sigma=1.1):
    """The FGS filter of (R, H, W) right-hand sides in float64."""
    u = src.astype(np.float64)
    for lam_t in tw.fgs_lambdas(lam, num_iters):
        a, b, c = fgs_systems(guide, lam_t, sigma)
        u = solve64(a[None], b[None], c[None], u)
        a, b, c = fgs_systems(guide.T.copy(), lam_t, sigma)
        u = np.swapaxes(solve64(a[None], b[None], c[None],
                                np.swapaxes(u, -1, -2)), -1, -2)
    return u


def guide_of(kind, H, W, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(0, 255, (H, W)).astype(np.float32)
    g = np.zeros((H, W), np.float32)           # a step edge, two levels
    g[:, W // 2:] = 255.0
    g[H // 2:, :] += 28.0
    return g


@pytest.mark.parametrize("N", [1, 2, 3, 50, 1280])
def test_thomas_solve_vs_float64(N):
    """Random strictly dominant systems like the FGS ones (b = 1 + |a| +
    |c|, |a|, |c| up to 2000), two right-hand sides sharing a, b, c."""
    rng = np.random.default_rng(N)
    a = -rng.uniform(0, 2000, (3, 1, N)).astype(np.float32)
    c = -rng.uniform(0, 2000, (3, 1, N)).astype(np.float32)
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    b = (1 + np.abs(a) + np.abs(c)).astype(np.float32)
    d = rng.uniform(0, 64, (3, 2, N)).astype(np.float32)
    got = tw.thomas_solve(T(a), T(b), T(c), T(d)).numpy()
    want = solve64(a, b, c, d.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # the plain version leaves a[..., 0] and c[..., -1] unread
    a[..., 0], c[..., -1] = 7.0, 7.0
    assert torch.equal(tw.thomas_solve(T(a), T(b), T(c), T(d)), T(got))


@pytest.mark.parametrize("kind", ["random", "step"])
def test_fgs_pass_vs_float64(kind):
    """One sweep each way on the lambda of the first iteration, where the
    systems are worst conditioned."""
    guide = guide_of(kind, 24, 40, seed=3)
    src = np.random.default_rng(5).uniform(0, 64, (2, 24, 40)).astype(
        np.float32)
    lam = tw.fgs_lambdas(8000.0, 3)[0]
    for axis in (-1, -2):
        got = tw.fgs_pass(T(src), T(guide), lam, 1.1, axis).numpy()
        g = guide if axis == -1 else guide.T.copy()
        u = src if axis == -1 else np.swapaxes(src, -1, -2)
        a, b, c = fgs_systems(g, lam, 1.1)
        want = solve64(a[None], b[None], c[None], u.astype(np.float64))
        if axis == -2:
            want = np.swapaxes(want, -1, -2)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # one thread's line equals the batched solve: the row sweep of the
        # transposed planes is the column sweep
        if axis == -2:
            rows = tw.fgs_pass(T(np.swapaxes(src, -1, -2).copy()),
                               T(guide.T.copy()), lam, 1.1, -1)
            assert torch.equal(T(got), rows.transpose(-1, -2))


@pytest.mark.parametrize("H,W", [(2, 3), (3, 2), (3, 3), (40, 64)])
@pytest.mark.parametrize("kind", ["random", "step"])
def test_fgs_filter_vs_jnp_and_pallas(kind, H, W):
    guide = guide_of(kind, H, W, seed=H * W)
    src = np.random.default_rng(W).uniform(0, 64, (2, H, W)).astype(
        np.float32)
    got = tw.fgs_filter(T(src), T(guide)).numpy()
    np.testing.assert_allclose(got, fgs64(src, guide), rtol=RTOL, atol=ATOL)
    want = np.stack([np.asarray(jw.fgs_filter(jnp.asarray(s),
                                              jnp.asarray(guide)))
                     for s in src])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(wp.fgs_filter_pallas(jnp.asarray(src[0]),
                                              jnp.asarray(guide)))
    np.testing.assert_allclose(got[0], pal, rtol=RTOL, atol=ATOL)
    # the distances, for the record (pytest -s)
    print(f"fgs_filter {kind} {H}x{W}: max |port - jnp| "
          f"{np.abs(got - want).max():.4g}, |port - Pallas| "
          f"{np.abs(got[0] - pal).max():.4g}, |port - float64| "
          f"{np.abs(got - fgs64(src, guide)).max():.4g}")


@pytest.mark.parametrize("H,W", [(1, 1), (1, 5), (6, 1)])
def test_fgs_filter_one_pixel_lines(H, W):
    """A line of one pixel is its own solution (b = 1, no neighbours);
    the other axis is smoothed as usual."""
    guide = guide_of("step", H, W, seed=1)
    src = np.random.default_rng(2).uniform(0, 64, (2, H, W)).astype(
        np.float32)
    got = tw.fgs_filter(T(src), T(guide))
    np.testing.assert_allclose(got.numpy(), fgs64(src, guide), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(wc.fgs_filter_cuda(T(src)[None], T(guide)[None])[0],
                       got)
    if H == W == 1:
        assert torch.equal(got, T(src))


def test_wls_disparity_filter_step_guide_vs_jnp_and_pallas():
    """The whole WLS filter with the Thomas sweep on a step-edge guide:
    confidence bitwise, the filtered disparity within the WLS bound, with
    equal invalid masks."""
    H, W = 32, 48
    rng = np.random.default_rng(8)
    guide = guide_of("step", H, W, seed=0)
    base = np.where(np.arange(W) < W // 2, 6.0, 14.0)[None, :]
    dl = np.float32(base + rng.normal(0, 0.4, (H, W)))
    dl[rng.uniform(size=dl.shape) < 0.2] = -1.0
    dr = np.float32(base + rng.normal(0, 0.6, (H, W)))
    dr[rng.uniform(size=dr.shape) < 0.1] = -1.0
    f, conf = tw.wls_disparity_filter(T(dl), T(dr), T(guide), max_disp=24)
    args = (jnp.asarray(dl), jnp.asarray(dr), jnp.asarray(guide))
    f_j, c_j = jw.wls_disparity_filter(*args)
    with pltpu.force_tpu_interpret_mode():
        f_p, c_p = wp.wls_disparity_filter_pallas(*args, max_disp=24)
    for f_r, c_r in ((f_j, c_j), (f_p, c_p)):
        np.testing.assert_array_equal(conf.numpy(), np.asarray(c_r))
        f_r = np.asarray(f_r)
        np.testing.assert_array_equal(f.numpy() < 0, f_r < 0)
        m = f_r >= 0
        np.testing.assert_allclose(f.numpy()[m], f_r[m], rtol=RTOL,
                                   atol=ATOL)
    assert float((f >= 0).float().mean()) > float(conf.mean())


def test_thomas_sweep_near_pcr_sweep():
    """The kernel's solve and the JAX package's (PCR with refinement, kept
    as ``tridiag_solve``) on the same FGS systems: the distance between
    the two sweeps stays far inside the WLS bound."""
    guide = guide_of("random", 40, 64, seed=9)
    src = np.random.default_rng(9).uniform(0, 64, (2, 40, 64)).astype(
        np.float32)
    a, b, c = (T(np.float32(x)) for x in fgs_systems(
        guide, tw.fgs_lambdas(8000.0, 3)[0], 1.1))
    thomas = tw.thomas_solve(a[None], b[None], c[None], T(src))
    pcr = tw.tridiag_solve(a[None], b[None], c[None], T(src))
    np.testing.assert_allclose(thomas.numpy(), pcr.numpy(), rtol=RTOL,
                               atol=ATOL / 4)
