"""The shared-cost pair (``pair_mode="shared"``) of the port against the JAX
package: the port's plain ``sgbm_pair`` against ``sgbm_pair_pallas`` (Pallas
in interpret mode) and the jnp ``compute_disparity_pair``, the plain
``cost_volume_pair`` and mirrored ``wta_lr`` against their definitions, and
the shared pipeline against the stacked one. Bitwise throughout, since every
cost and path value is an exact small integer; only the filtered disparity
against the JAX pipeline is held at the WLS bound of
tests/test_torch_pipeline.py."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_depth_ruler_tpu import pipeline as jp
from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.io.synthetic import make_scene, render_stereo_pair
from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops import sgbm_pallas as sp
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch import StereoRig as TorchRig
from stereo_depth_ruler_tpu_torch import pipeline as tp
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as tc
from stereo_depth_ruler_tpu_torch.ops.remap import RemapGrid

WLS_RTOL, WLS_ATOL = 2e-3, 2e-2
RIG = dict(width=64, height=48, focal=60.0, baseline_mm=40.0)


def T(a):
    return torch.tensor(np.asarray(a))


def eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def shifted_pair(H, W, seed, shift=5):
    """A random texture and its copy shifted left by ``shift`` plus noise,
    as tests/test_sgbm_pallas.py:test_pair_shared_cost_parity makes them."""
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    right = (np.roll(left, -shift, axis=1)
             + rng.normal(0, 2, (H, W)).astype(np.float32))
    return left, right


def jax_pairs(left, right, params):
    """(dl, dr) of the jnp compute_disparity_pair and of sgbm_pair_pallas
    in interpret mode, as numpy."""
    jparams = JaxParams(**dataclasses.asdict(params))
    ref = js.compute_disparity_pair(jnp.asarray(left), jnp.asarray(right),
                                    jparams)
    with pltpu.force_tpu_interpret_mode():
        pal = sp.sgbm_pair_pallas(jnp.asarray(left), jnp.asarray(right),
                                  jparams)
    return [tuple(np.asarray(a) for a in p) for p in (ref, pal)]


@pytest.mark.parametrize("shape", [(64, 256, 32), (48, 160, 16)])
def test_sgbm_pair_vs_jax(shape):
    H, W, D = shape
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=50, speckle_range=2)
    left, right = shifted_pair(H, W, seed=H + W)
    dl, dr = ts.sgbm_pair(T(left), T(right), params)
    for want_l, want_r in jax_pairs(left, right, params):
        eq(dl, want_l)
        eq(dr, want_r)
    assert bool((dl >= 0).any()) and bool((dr >= 0).any())
    # the kernel wrapper's CPU path on a batch of one
    gl, gr = tc.sgbm_pair_cuda(T(left)[None], T(right)[None], params)
    assert torch.equal(gl[0], dl) and torch.equal(gr[0], dr)


@pytest.mark.parametrize("H,W,kw", [
    (32, 48, dict(block_size=1, p1=8, p2=32)),    # r = 0: no left band
    (24, 24, dict(block_size=5)),                 # W <= D + 2r + 4: all band
], ids=["block_size_1", "all_band"])
def test_sgbm_pair_edge_cases(H, W, kw):
    params = SGBMParams(num_disparities=16, speckle_window_size=0, **kw)
    left, right = shifted_pair(H, W, seed=W, shift=3)
    dl, dr = ts.sgbm_pair(T(left), T(right), params)
    el, er = ts.compute_disparity_pair(T(left), T(right), params)
    assert torch.equal(dl, el) and torch.equal(dr, er)
    for want_l, want_r in jax_pairs(left, right, params):
        eq(dl, want_l)
        eq(dr, want_r)
    gl, gr = tc.sgbm_pair_cuda(T(left)[None], T(right)[None], params)
    assert torch.equal(gl[0], dl) and torch.equal(gr[0], dr)


@pytest.fixture(scope="module")
def path_sums():
    """(2, 24, 40, 16) path sums of a seeded pair, and a random volume."""
    left, right = shifted_pair(24, 40, seed=4, shift=6)
    p = SGBMParams(num_disparities=16, block_size=5)
    C = ts.cost_volume(ts.sobel_clip(T(np.stack([left, right])), 63),
                       ts.sobel_clip(T(np.stack([right, left])), 63), p)
    S = ts.aggregate_paths(C, p.P1, p.P2, 8)
    rng = np.random.default_rng(5)
    return S, T(rng.integers(0, 400, S.shape).astype(np.float32))


@pytest.mark.parametrize("min_disp", [0, 3])
@pytest.mark.parametrize("quantize_16", [True, False])
@pytest.mark.parametrize("apply_lr", [True, False])
def test_wta_lr_mirror_is_flipped_wta_lr(path_sums, apply_lr, quantize_16,
                                         min_disp):
    params = SGBMParams(num_disparities=16, quantize_16=quantize_16,
                        min_disparity=min_disp)
    for S in path_sums:
        got = ts.wta_lr(S, params, apply_lr, mirror_lr=True)
        assert torch.equal(got, ts.wta_lr(S.flip(-2), params,
                                          apply_lr).flip(-1))
        assert bool((got >= 0).any()) and bool((got < 0).any())


@pytest.mark.parametrize("mirror_from", [None, 0, 1])
def test_wta_lr_wrapper_mirror_from(path_sums, mirror_from):
    """The K3 wrapper's CPU path: frames before ``mirror_from`` plain,
    the rest mirrored."""
    S = path_sums[0]
    params = SGBMParams(num_disparities=16)
    got = tc.wta_lr(S.to(torch.int32), params, mirror_from=mirror_from)
    m = 2 if mirror_from is None else mirror_from
    for b in range(2):
        eq(got[b], ts.wta_lr(S[b], params, mirror_lr=b >= m))
    with pytest.raises(ValueError, match="mirror_from"):
        tc.wta_lr(S.to(torch.int32), params, mirror_from=3)


@pytest.mark.parametrize("block,min_disp", [(5, 0), (1, 0), (3, 2)])
def test_cost_volume_pair(block, min_disp):
    params = SGBMParams(num_disparities=16, block_size=block,
                        min_disparity=min_disp)
    left, right = shifted_pair(20, 40, seed=block, shift=4)
    lt, rt = ts.sobel_clip(T(left), 63), ts.sobel_clip(T(right), 63)
    C_L, C_R = ts.cost_volume_pair(lt, rt, params)
    assert torch.equal(C_L, ts.cost_volume(lt, rt, params))
    # the right matcher's own build, on the mirrored, swapped frames
    lt_m = ts.sobel_clip(T(right).flip(-1), 63)
    rt_m = ts.sobel_clip(T(left).flip(-1), 63)
    assert torch.equal(C_R, ts.cost_volume(lt_m, rt_m, params).flip(-2))
    want = js.box_filter_volume(
        js.bt_cost_volume(jnp.asarray(lt_m.numpy()), jnp.asarray(rt_m.numpy()),
                          16, min_disp), block)
    eq(C_R, np.asarray(want)[:, ::-1])
    # the shear of the TPU's pair kernel, exact off the border bands
    r, W = block // 2, 40
    for d in range(16):
        xs = np.arange(r, W - r - d - min_disp)
        assert torch.equal(C_R[:, xs, d], C_L[:, xs + d + min_disp, d])
    got = tc.cost_volume_pair(lt[None], rt[None], params)
    assert got.dtype == torch.int16 and got.shape == (2, 20, 40, 16)
    assert torch.equal(got.float(), torch.stack([C_L, C_R]))


@pytest.fixture(scope="module")
def rig():
    return StereoRig.synthetic(**RIG)


@pytest.fixture(scope="module")
def frames(rig):
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 500.0),
                       background_z_mm=900.0, seed=2)
    pairs = [render_stereo_pair(scene, seed=2, shift=(2.0 * i, 0.0))
             for i in range(2)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


PIPE_PARAMS = SGBMParams(num_disparities=16, block_size=5,
                         speckle_window_size=20, speckle_range=2)


def test_pipeline_shared_vs_stacked(rig, frames):
    """The shared pair against the stacked one in the port (every output
    bitwise, since the WLS input is identical) and against the JAX stacked
    pipeline at the WLS bound."""
    cfg = dict(sgbm=PIPE_PARAMS, downscale=1, use_wls=True,
               lr_mode="right_matcher")
    jcfg = dict(cfg, sgbm=JaxParams(**dataclasses.asdict(PIPE_PARAMS)))
    pj = jp.StereoPipeline(rig, jp.PipelineConfig(matcher="jnp",
                                                  pair_mode="stacked",
                                                  **jcfg))
    grids = tuple(RemapGrid.from_arrays(np.asarray(g.idx00), np.asarray(g.wx),
                                        np.asarray(g.wy), np.asarray(g.valid),
                                        g.src_shape, "cpu")
                  for g in (pj.grid_l, pj.grid_r))
    trig = TorchRig.synthetic(**RIG)
    shared, stacked = (tp.StereoPipeline(trig, tp.PipelineConfig(
        pair_mode=mode, **cfg), device="cpu", grids=grids)
        for mode in ("shared", "stacked"))
    lefts, rights = frames
    got = shared.process_batch(lefts, rights)
    ref = stacked.process_batch(lefts, rights)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    one = shared.process_pair(lefts[1], rights[1])
    for k in ref:
        assert torch.equal(one[k], ref[k][1]), k

    want = pj.process_batch(np.float32(lefts), np.float32(rights))
    eq(got["confidence"], want["confidence"])
    disp, want_disp = got["disparity"].numpy(), np.asarray(want["disparity"])
    np.testing.assert_array_equal(disp < 0, want_disp < 0)
    m = want_disp >= 0
    np.testing.assert_allclose(disp[m], want_disp[m], rtol=WLS_RTOL,
                               atol=WLS_ATOL)
    assert m.mean() > 0.9


@pytest.mark.parametrize("kw", [dict(min_disparity=2), dict(num_paths=2)],
                         ids=["min_disparity", "num_paths"])
def test_shared_pair_rejects(kw):
    """Where sgbm_pair_pallas asserts, the port raises ValueError: in the
    matcher, and so in the pipeline's first call."""
    params = SGBMParams(num_disparities=16, speckle_window_size=0, **kw)
    img = np.zeros((1, 8, 32), np.uint8)
    with pytest.raises(ValueError, match="shared-cost pair"):
        tc.sgbm_pair_cuda(T(img).float(), T(img).float(), params)
    cfg = tp.PipelineConfig(sgbm=params, downscale=1, pair_mode="shared")
    pipe = tp.StereoPipeline(TorchRig.synthetic(width=32, height=8), cfg,
                             device="cpu")
    with pytest.raises(ValueError, match="shared-cost pair"):
        pipe.process_batch(img, img)
