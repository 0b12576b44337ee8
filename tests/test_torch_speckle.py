"""The port's speckle filter (plain labels and keep in ops.sgbm, the CPU
path of the ops.sgbm_cuda wrappers) against the JAX package's jnp filter,
its Pallas labels kernel and filter in interpret mode, and the NumPy
oracle. Labels and masks are integers and booleans: all bitwise."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops import sgbm_pallas as sp
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu.ops.sgbm_ref import sgbm_numpy
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as tc
from test_speckle_bound import _serpentine
from test_torch_cuda import comb as _comb
from test_torch_cuda import staircase as _staircase

PARAMS = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                    speckle_window_size=20, speckle_range=2)


def jax_params(params):
    return JaxParams(**dataclasses.asdict(params))


def natural():
    """Two disparity maps of a rendered scene: ground truth with noise,
    quantised to 1/16 px, a quarter of the pixels invalid."""
    from stereo_depth_ruler_tpu_torch import StereoRig
    from stereo_depth_ruler_tpu_torch.io.synthetic import (make_scene,
                                                           render_stereo_pair)
    rig = StereoRig.synthetic(width=96, height=64, focal=90.0,
                              baseline_mm=50.0)
    scene = make_scene(rig, n_boxes=3, z_range_mm=(300.0, 900.0),
                       background_z_mm=1500.0, seed=4)
    rng = np.random.default_rng(4)
    maps = []
    for i in range(2):
        gt = render_stereo_pair(scene, seed=4, shift=(3.0 * i, 0.0))[2]
        d = np.round((gt + rng.normal(0, 0.8, gt.shape)) * 16) / 16
        d[rng.uniform(size=d.shape) < 0.25] = -1.0
        maps.append(d)
    return np.float32(np.stack(maps))


def serpentine():
    """The adversarial single snake, and its mirror."""
    d = _serpentine(64, 96, pitch=2)
    return np.float32(np.stack([d, d[::-1, ::-1]]))


def noisy():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 5, (2, 32, 64)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.25] = -1.0
    return d


def invalid():
    """An all-invalid frame beside a valid one."""
    d = np.full((2, 24, 40), -1.0, np.float32)
    d[1, 4:20, 5:30] = 3.0
    return d


def comb():
    """A comb whose teeth hang from the top row, and its mirror."""
    d = _comb(48, 160)
    return np.float32(np.stack([d, d[::-1, ::-1]]))


def staircase():
    """A staircase one pixel wide, rows linked only by vertical steps, and
    its mirror."""
    d = _staircase(48, 160)
    return np.float32(np.stack([d, d[::-1]]))


CASES = {"natural": natural, "serpentine": serpentine, "noisy": noisy,
         "all_invalid": invalid, "comb": comb, "staircase": staircase}
MAX_DIFF = {"natural": 2.0, "serpentine": 1.0, "noisy": 1.0,
            "all_invalid": 1.0, "comb": 1.0, "staircase": 1.0}


def pallas_labels(disp, max_diff, max_iters=0):
    with pltpu.force_tpu_interpret_mode():
        return np.stack([np.asarray(sp.speckle_labels_pallas(
            jnp.asarray(d), max_diff, max_iters)) for d in disp])


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_match_pallas(case):
    disp = CASES[case]()
    got = ts.speckle_labels(torch.tensor(disp), MAX_DIFF[case])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  pallas_labels(disp, MAX_DIFF[case]))
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        tc.speckle_labels(torch.tensor(disp), MAX_DIFF[case]).numpy(),
        got.numpy())


def test_capped_labels_match_pallas_round_for_round():
    """A capped run stops after the same rounds of sweeps as the TPU
    kernel's, so even unconverged labels agree."""
    disp = serpentine()
    for max_iters in (1, 3):
        got = ts.speckle_labels(torch.tensor(disp), 1.0, max_iters)
        np.testing.assert_array_equal(
            got.numpy(), pallas_labels(disp, 1.0, max_iters))
    full = ts.speckle_labels(torch.tensor(disp), 1.0)
    assert not torch.equal(
        ts.speckle_labels(torch.tensor(disp), 1.0, 1), full)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_size", [8, 40])
def test_keep_matches_jnp_and_pallas(case, max_size):
    disp = CASES[case]()
    md = MAX_DIFF[case]
    t = torch.tensor(disp)
    labels = ts.speckle_labels(t, md)
    got = ts.speckle_keep(t, labels, max_size)
    assert torch.equal(tc.speckle_keep(t, labels, max_size), got)
    dj = jnp.asarray(disp)
    keep_j = np.asarray(jax.vmap(
        lambda d: js.speckle_filter(d, d >= 0, max_size, md))(dj))
    np.testing.assert_array_equal(got.numpy(), np.where(keep_j, disp, -1.0))
    np.testing.assert_array_equal(
        ts.speckle_filter(t, t >= 0, max_size, md).numpy(), keep_j)
    if max_size == 40:   # one Pallas compile per map shape keeps this short
        with pltpu.force_tpu_interpret_mode():
            keep_p = np.asarray(jax.vmap(
                lambda d: sp.speckle_filter_pallas(d, max_size, md))(dj))
        np.testing.assert_array_equal(keep_p, keep_j)


@pytest.mark.parametrize("case,max_size", [("natural", 40), ("noisy", 8),
                                           ("serpentine", 400)])
def test_capped_filter_matches_pallas(case, max_size):
    """The capped speckle_filter (labels after 2 rounds, then the
    sort-based keep; on the CPU the plain versions) against
    speckle_filter_pallas(..., max_iters=2), bitwise. The serpentine is
    split by the cap into pieces of at most 400 pixels."""
    disp = CASES[case]()
    md = MAX_DIFF[case]
    t = torch.tensor(disp)
    got = tc.speckle_filter(t, max_size, md, max_iters=2)
    assert got.dtype == torch.bool
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.vmap(lambda d: sp.speckle_filter_pallas(
            d, max_size, md, max_iters=2))(jnp.asarray(disp)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ts.speckle_filter(t, t >= 0, max_size, md, 2))
    full = tc.speckle_filter(t, max_size, md)
    assert torch.equal(full, ts.speckle_filter(t, t >= 0, max_size, md))
    assert not (got & ~full).any()
    if case == "serpentine":
        assert not torch.equal(got, full)


def test_sgbm_with_speckle_vs_jnp_and_oracle(tiny_pair):
    left, right, _ = tiny_pair
    want = js.sgbm(jnp.float32(left), jnp.float32(right),
                   jax_params(PARAMS))
    got = ts.sgbm(torch.tensor(np.float32(left)),
                  torch.tensor(np.float32(right)), PARAMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  sgbm_numpy(left, right, PARAMS))
    # the speckle filter changed something on this pair
    no_speckle = ts.sgbm(torch.tensor(np.float32(left)),
                         torch.tensor(np.float32(right)), PARAMS,
                         apply_speckle=False)
    assert not torch.equal(got, no_speckle)


def test_sgbm_cuda_cpu_path_with_speckle_vs_jnp():
    """The kernel matcher's CPU dispatch with the speckle filter on, on a
    batch of two seeded pairs (min_disparity 2, D 32)."""
    params = SGBMParams(num_disparities=32, min_disparity=2, block_size=5,
                        speckle_window_size=30, speckle_range=1)
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (2, 24, 64)).astype(np.float32)
    right = (np.roll(left, -9, axis=2)
             + rng.normal(0, 6, left.shape)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda a, b: js.sgbm(a, b, jax_params(params))))(
        jnp.asarray(left), jnp.asarray(right))
    got = tc.sgbm_cuda(torch.tensor(left), torch.tensor(right), params)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_disparity_pair_vs_jnp(tiny_pair):
    left, right, _ = tiny_pair
    dl_j, dr_j = js.compute_disparity_pair(jnp.float32(left),
                                           jnp.float32(right),
                                           jax_params(PARAMS))
    dl, dr = ts.compute_disparity_pair(torch.tensor(np.float32(left)),
                                       torch.tensor(np.float32(right)),
                                       PARAMS)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(dl_j))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(dr_j))
