"""The port's WLS filter (plain versions in ops.wls, the CPU path of the
ops.wls_cuda wrappers) against the JAX package's jnp filter and its Pallas
kernels in interpret mode.

The gather and the confidence are compared bitwise, and so is the
tridiagonal solve. The filtered disparity is held to the JAX package's own
Pallas-vs-jnp bound, rtol 2e-3 and atol 2e-2 with equal invalid masks:
exp and the order of the float sums differ between XLA and PyTorch, and
the λ = 8000 systems (condition number ~2λ) amplify a last-bit
difference. Measured at these sizes: fgs_filter within 5e-3 absolute of
the jnp filter and 7e-3 of the Pallas one (values up to 64)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_depth_ruler_tpu.ops import wls as jw
from stereo_depth_ruler_tpu.ops import wls_pallas as wp
from stereo_depth_ruler_tpu_torch.ops import wls as tw
from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc

RTOL, ATOL = 2e-3, 2e-2


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def data():
    """Two frames: guides (2, H, W), stacked right-hand sides (2, 2, H, W)
    and a left/right disparity pair with a fifth of the pixels invalid."""
    rng = np.random.default_rng(4)
    guide = rng.uniform(0, 255, (2, 40, 64)).astype(np.float32)
    src = rng.uniform(0, 64, (2, 2, 40, 64)).astype(np.float32)
    # bands of constant disparity 4..22 seen from both views, with noise
    base = 4.0 + 2.0 * (np.arange(40) // 4)[None, :, None]
    dl = np.float32(base + rng.normal(0, 0.4, guide.shape))
    dl[rng.uniform(size=dl.shape) < 0.2] = -1.0
    dl[0, 3, 10] = 2.5          # exact halves: round half to even
    dl[0, 3, 11] = 3.5
    dr = np.float32(base + rng.normal(0, 0.6, guide.shape))
    dr[rng.uniform(size=dr.shape) < 0.1] = -1.0
    return guide, src, dl, dr


def test_tridiag_solve_bitwise():
    rng = np.random.default_rng(1)
    a = -rng.uniform(0, 100, (3, 50)).astype(np.float32)
    c = -rng.uniform(0, 100, (3, 50)).astype(np.float32)
    b = (1 + np.abs(a) + np.abs(c)).astype(np.float32)
    d = rng.uniform(-5, 5, (3, 50)).astype(np.float32)
    want = jw.tridiag_solve(*map(jnp.asarray, (a, b, c, d)))
    got = tw.tridiag_solve(*map(T, (a, b, c, d)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the solution solves the system
    A = np.diag(b[0]) + np.diag(a[0, 1:], -1) + np.diag(c[0, :-1], 1)
    np.testing.assert_allclose(A @ got[0].double().numpy(), d[0], atol=1e-3)


def test_fgs_filter_vs_jnp_and_pallas(data):
    guide, src, _, _ = data
    got = tw.fgs_filter(T(src), T(guide)).numpy()
    for i in range(2):
        want = np.asarray(jw.fgs_filter(jnp.asarray(src[i]),
                                        jnp.asarray(guide[i])))
        np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL)
        with pltpu.force_tpu_interpret_mode():
            pal = np.asarray(wp.fgs_filter_pallas(jnp.asarray(src[i]),
                                                  jnp.asarray(guide[i])))
        np.testing.assert_allclose(got[i], pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis", [-1, -2])
def test_fgs_pass_wrapper_cpu_path(data, axis):
    """The K6 wrapper's CPU path is one plain sweep along ``axis``; a
    column sweep is a row sweep of the transposed planes."""
    guide, src, _, _ = data
    u, g = T(src), T(guide)
    got = wc.fgs_pass(u, g, 1000.0, 1.1, axis)
    assert torch.equal(got, tw.fgs_pass(u, g, 1000.0, 1.1, axis))
    if axis == -2:
        rows = tw.fgs_pass(u.transpose(-1, -2).contiguous(),
                           g.transpose(-1, -2).contiguous(), 1000.0, 1.1, -1)
        assert torch.equal(got, rows.transpose(-1, -2))


@pytest.mark.parametrize("max_shift,fill", [(32, -7.0), (7, -1e9)])
def test_shift_gather_vs_pallas(max_shift, fill):
    """Negative, in-range, top (s == max_shift) and over-range shifts."""
    rng = np.random.default_rng(9)
    v = rng.uniform(-5, 90, (16, 64)).astype(np.float32)
    s = rng.integers(-3, max_shift + 4, (16, 64)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = wp.shift_gather_pallas(jnp.asarray(v), jnp.asarray(s),
                                      max_shift, fill)
    got = tw.shift_gather(T(v), T(s), max_shift, fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_filtered(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got < 0, want < 0)
    m = want >= 0
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def test_wls_disparity_filter_vs_jnp_and_pallas(data):
    guide, _, dl, dr = data
    f, conf = tw.wls_disparity_filter(T(dl), T(dr), T(guide), max_disp=24)
    f_w, conf_w = wc.wls_disparity_filter_cuda(T(dl), T(dr), T(guide),
                                               max_disp=24)
    assert torch.equal(f_w, f) and torch.equal(conf_w, conf)
    for i in range(2):
        args = (jnp.asarray(dl[i]), jnp.asarray(dr[i]), jnp.asarray(guide[i]))
        f_j, c_j = jw.wls_disparity_filter(*args)
        np.testing.assert_array_equal(conf[i].numpy(), np.asarray(c_j))
        check_filtered(f[i], f_j)
        with pltpu.force_tpu_interpret_mode():
            f_p, c_p = wp.wls_disparity_filter_pallas(*args, max_disp=24)
        np.testing.assert_array_equal(conf[i].numpy(), np.asarray(c_p))
        check_filtered(f[i], f_p)
    assert 0.3 < float(conf.mean()) < 0.9     # both kinds of pixel occur
    # inpainting: more valid pixels out than confident ones in
    assert float((f >= 0).float().mean()) > float(conf.mean())


def test_shift_gather_conf_rhs(data):
    """The right-hand sides are (conf * max(dl, 0), conf), bitwise the
    jnp filter's stacked numerator and denominator inputs."""
    _, _, dl, dr = data
    rhs = wc.shift_gather_conf(T(dl), T(dr), 24)
    assert rhs.shape == (2, 2) + dl.shape[1:]
    for i in range(2):
        _, c_j = jw.wls_disparity_filter(jnp.asarray(dl[i]),
                                         jnp.asarray(dr[i]),
                                         jnp.asarray(dl[i]), num_iters=1)
        c_j = np.asarray(c_j)
        np.testing.assert_array_equal(rhs[i, 1].numpy(), c_j)
        np.testing.assert_array_equal(rhs[i, 0].numpy(),
                                      c_j * np.maximum(dl[i], 0.0))


def test_lambda_schedule_matches_jax():
    want = [np.float32(1.5 * 8000.0 * (4.0 ** (3 - t - 1)) / 63.0)
            for t in range(3)]
    assert tw.fgs_lambdas(8000.0, 3) == [float(w) for w in want]
