"""The port's matcher (stereo_depth_ruler_tpu_torch.ops.sgbm and the CPU
path of ops.sgbm_cuda) against the JAX package's jnp matcher, its Pallas
kernels in interpret mode and the NumPy oracle: bitwise, since every cost
and path value is an exact small integer."""

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

PARAMS = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                    speckle_window_size=0)
JPARAMS = JaxParams(**dataclasses.asdict(PARAMS))


def T(a):
    return torch.tensor(np.asarray(a))


def eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def imgs(tiny_pair):
    left, right, _ = tiny_pair
    return np.float32(left), np.float32(right)


@pytest.fixture(scope="module")
def cost(imgs):
    """(lt, rt, C) from the jnp matcher, as numpy."""
    left, right = imgs
    lt = js.sobel_clip(jnp.asarray(left), 63)
    rt = js.sobel_clip(jnp.asarray(right), 63)
    C = js.box_filter_volume(js.bt_cost_volume(lt, rt, 16), 5)
    return np.asarray(lt), np.asarray(rt), np.asarray(C)


@pytest.fixture(scope="module")
def S8(cost):
    return np.asarray(js.aggregate_paths(jnp.asarray(cost[2]), PARAMS.P1,
                                         PARAMS.P2, 8))


def test_sobel_clip(imgs, cost):
    # a non-integral input checks the truncation to int before the Sobel
    left = imgs[0] + np.float32(0.75)
    eq(ts.sobel_clip(T(left), 63), js.sobel_clip(jnp.asarray(left), 63))
    eq(ts.sobel_clip(T(imgs[0]), 63), cost[0])


@pytest.mark.parametrize("min_disp", [0, 3])
def test_bt_cost_volume(cost, min_disp):
    lt, rt, _ = cost
    want = js.bt_cost_volume(jnp.asarray(lt), jnp.asarray(rt), 16, min_disp)
    eq(ts.bt_cost_volume(T(lt), T(rt), 16, min_disp), want)


@pytest.mark.parametrize("block", [3, 5])
def test_box_filter_volume(cost, block):
    lt, rt, _ = cost
    raw = np.asarray(js.bt_cost_volume(jnp.asarray(lt), jnp.asarray(rt), 16))
    eq(ts.box_filter_volume(T(raw), block),
       js.box_filter_volume(jnp.asarray(raw), block))


@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_aggregate_paths(cost, num_paths):
    C = cost[2]
    want = js.aggregate_paths(jnp.asarray(C), PARAMS.P1, PARAMS.P2,
                              num_paths)
    eq(ts.aggregate_paths(T(C), PARAMS.P1, PARAMS.P2, num_paths), want)


def test_sgm_pass_wrapper_sums_to_aggregate(cost, S8):
    """The CPU path of the K2 wrapper: 8 in-place passes into int32 S."""
    C = T(cost[2]).to(torch.int16)[None]
    S = tc.aggregate(C, PARAMS)
    assert S.dtype == torch.int32 and S.shape == C.shape
    eq(S[0], S8.astype(np.int32))


def test_wta(S8):
    d_j, v_j = js.wta(jnp.asarray(S8), JPARAMS)
    d_t, v_t = ts.wta(T(S8), PARAMS)
    eq(d_t, d_j)
    eq(v_t, v_j)


def test_lr_check(S8):
    d_j, v_j = js.wta(jnp.asarray(S8), JPARAMS)
    want = js.lr_check(jnp.asarray(S8), d_j, v_j, JPARAMS)
    d_t, v_t = ts.wta(T(S8), PARAMS)
    eq(ts.lr_check(T(S8), d_t, v_t, PARAMS), want)


@pytest.mark.parametrize("apply_lr", [True, False])
def test_sgbm_vs_jnp(imgs, apply_lr):
    left, right = imgs
    want = js.sgbm(jnp.asarray(left), jnp.asarray(right), JPARAMS,
                   apply_lr=apply_lr)
    eq(ts.sgbm(T(left), T(right), PARAMS, apply_lr=apply_lr), want)


def test_sgbm_vs_numpy_oracle(imgs, tiny_pair):
    left, right, _ = tiny_pair
    want = sgbm_numpy(left, right, JPARAMS)
    eq(ts.sgbm(T(imgs[0]), T(imgs[1]), PARAMS), want)


def test_sgbm_vs_pallas_interpret(imgs):
    left, right = imgs
    with pltpu.force_tpu_interpret_mode():
        want = sp.sgbm_pallas(jnp.asarray(left), jnp.asarray(right),
                              JPARAMS)
    eq(ts.sgbm(T(left), T(right), PARAMS), np.asarray(want))


def test_sgbm_cuda_cpu_batch_vs_jnp():
    """The kernel matcher's CPU dispatch on a batch of two seeded pairs
    at D = 32, min_disparity 2, default P1/P2."""
    params = SGBMParams(num_disparities=32, min_disparity=2, block_size=5,
                        speckle_window_size=0)
    rng = np.random.default_rng(7)
    left = rng.uniform(0, 255, (2, 20, 48)).astype(np.float32)
    right = (np.roll(left, -9, axis=2)
             + rng.normal(0, 2, left.shape)).astype(np.float32)
    jparams = JaxParams(**dataclasses.asdict(params))
    want = jax.jit(jax.vmap(lambda a, b: js.sgbm(a, b, jparams)))(
        jnp.asarray(left), jnp.asarray(right))
    eq(tc.sgbm_cuda(T(left), T(right), params), want)


def test_speckle_and_negative_min_disparity_raise(imgs):
    """The speckle filter runs (default window 200, range 2), in the plain
    matcher and in the kernel matcher's CPU path alike; a negative
    min_disparity with the LR check is refused, as by the jnp matcher."""
    left, right = T(imgs[0]), T(imgs[1])
    params = SGBMParams(num_disparities=16)
    got = ts.sgbm(left, right, params)
    eq(tc.sgbm_cuda(left[None], right[None], params)[0], got)
    eq(got, sgbm_numpy(imgs[0], imgs[1], JaxParams(num_disparities=16)))
    with pytest.raises(ValueError, match="min_disparity"):
        tc.sgbm_cuda(left[None], right[None],
                     SGBMParams(num_disparities=16, min_disparity=-2,
                                speckle_window_size=0))
