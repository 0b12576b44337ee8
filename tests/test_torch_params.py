"""The port's matcher entry points on the CPU take every parameter set the
JAX package's jnp matcher takes: the CUDA kernels' limits (D a multiple of
16 in [16, 256], min_disparity >= 0) apply only to CUDA tensors. Held
bitwise against the jnp matcher, through ``sgbm_cuda``, the staged chain
and ``StereoPipeline(device="cpu")``; and ``sgbm_cuda``'s
``apply_speckle``, as the reference's ``sgbm`` has it.

The jnp matcher cannot run a negative min_disparity with the LR check (its
winner scatter pads by a negative width), and the port refuses it too, so
those cases turn the check off with disp12_max_diff = -1. One of them runs
the speckle filter: it must be told validity by the WTA mask, not by
disp >= 0, or it drops the valid negative disparities the jnp matcher
keeps."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereo_depth_ruler_tpu import pipeline as jp
from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch import StereoRig as TorchRig
from stereo_depth_ruler_tpu_torch import pipeline as tp
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.ops.remap import RemapGrid

CASES = {
    "D40": dict(num_disparities=40, speckle_window_size=10),
    "D24_block3": dict(num_disparities=24, block_size=3,
                       speckle_window_size=0),
    "md-3": dict(num_disparities=16, min_disparity=-3, disp12_max_diff=-1,
                 speckle_window_size=0),
    "md-3_speckle": dict(num_disparities=16, min_disparity=-3,
                         disp12_max_diff=-1, speckle_window_size=10,
                         speckle_range=1),
}


def pair(H, W, shift, seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -shift, axis=2)
                    + rng.normal(0, 2, left.shape), 0, 255)
    return left, right.astype(np.float32)


def jnp_sgbm(left, right, params, **kw):
    jparams = JaxParams(**dataclasses.asdict(params))
    return np.stack([np.asarray(js.sgbm(jnp.asarray(l), jnp.asarray(r),
                                        jparams, **kw))
                     for l, r in zip(left, right)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sgbm_cuda_on_cpu_takes_reference_params(case):
    params = SGBMParams(**CASES[case])
    left, right = pair(24, 72, 7, seed=len(case))
    got = sc.sgbm_cuda(torch.tensor(left), torch.tensor(right), params)
    want = jnp_sgbm(left, right, params)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).mean() > 0.5
    # the staged chain's plain path: the same map
    staged = sc.sgbm_staged_cuda(torch.tensor(left), torch.tensor(right),
                                 params)
    np.testing.assert_array_equal(staged.numpy(), want)
    if params.min_disparity < 0:
        assert ((want < 0) & (want != -1.0)).any()   # valid negatives kept
        with_lr = dataclasses.replace(params, disp12_max_diff=1)
        with pytest.raises(ValueError):
            jnp_sgbm(left, right, with_lr)
        with pytest.raises(ValueError, match="min_disparity"):
            sc.sgbm_cuda(torch.tensor(left), torch.tensor(right), with_lr)
        with pytest.raises(ValueError, match="min_disparity"):
            sc.sgbm_staged_cuda(torch.tensor(left), torch.tensor(right),
                                with_lr)


def test_staged_on_cpu_keeps_valid_negative_disparities():
    """The staged chain alone at min_disparity -3 with the speckle filter
    on: bitwise the jnp matcher, valid negative disparities kept."""
    params = SGBMParams(**CASES["md-3_speckle"])
    left, right = pair(40, 64, 5, seed=3)
    got = sc.sgbm_staged_cuda(torch.tensor(left), torch.tensor(right),
                              params)
    want = jnp_sgbm(left, right, params)
    assert ((want < 0) & (want != -1.0)).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_sgbm_cuda_apply_speckle():
    """apply_speckle=False returns the map before the speckle filter, as
    the reference's sgbm(apply_speckle=False); the default filters."""
    params = SGBMParams(num_disparities=16, speckle_window_size=40,
                        speckle_range=1)
    left, right = pair(32, 64, 5, seed=11)
    lt, rt = torch.tensor(left), torch.tensor(right)
    raw = sc.sgbm_cuda(lt, rt, params, apply_speckle=False)
    np.testing.assert_array_equal(
        raw.numpy(), jnp_sgbm(left, right, params, apply_speckle=False))
    assert torch.equal(raw, ts.sgbm(lt, rt, params, apply_speckle=False))
    kept = sc.sgbm_cuda(lt, rt, params)
    np.testing.assert_array_equal(kept.numpy(), jnp_sgbm(left, right, params))
    assert torch.equal(kept, sc.sgbm_cuda(lt, rt, params, apply_speckle=True))
    # the filter removed something, and only valid pixels
    removed = (raw >= 0) & (kept < 0)
    assert bool(removed.any()) and torch.equal(kept[kept >= 0],
                                               raw[kept >= 0])


RIG = dict(width=64, height=48, focal=60.0, baseline_mm=40.0)


@pytest.mark.parametrize("case,lr_mode", [("D40", "fast"),
                                          ("md-3", "fast"),
                                          ("md-3_speckle", "fast"),
                                          ("D24_block3", "none")])
def test_pipeline_on_cpu_takes_reference_params(case, lr_mode):
    """StereoPipeline(device="cpu") against the JAX pipeline's jnp matcher
    on the same frames and rectification tables: the disparity bitwise."""
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.io.synthetic import (make_scene,
                                                     render_stereo_pair)
    params = SGBMParams(**CASES[case])
    rig = StereoRig.synthetic(**RIG)
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 500.0),
                       background_z_mm=900.0, seed=4)
    frames = [render_stereo_pair(scene, seed=4, shift=(2.0 * i, 0.0))
              for i in range(2)]
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    cfg = dict(downscale=1, use_wls=False, lr_mode=lr_mode)
    pj = jp.StereoPipeline(rig, jp.PipelineConfig(
        matcher="jnp", sgbm=JaxParams(**dataclasses.asdict(params)), **cfg))
    grids = tuple(RemapGrid.from_arrays(np.asarray(g.idx00), np.asarray(g.wx),
                                        np.asarray(g.wy), np.asarray(g.valid),
                                        g.src_shape, "cpu")
                  for g in (pj.grid_l, pj.grid_r))
    pt = tp.StereoPipeline(TorchRig.synthetic(**RIG),
                           tp.PipelineConfig(sgbm=params, **cfg),
                           device="cpu", grids=grids)
    got = pt.process_batch(lefts, rights)["disparity"].numpy()
    want = np.asarray(pj.process_batch(np.float32(lefts),
                                       np.float32(rights))["disparity"])
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).mean() > 0.3
