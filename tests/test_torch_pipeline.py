"""The port's StereoPipeline against the JAX StereoPipeline (jnp matcher)
on the undistorted synthetic rig, both fed the same numpy frames and the
same rectification tables (the JAX grids carried across with
RemapGrid.from_arrays).

Disparity is compared bitwise; xyz and the stats at rtol 1e-5, since XLA
and PyTorch may order or contract the float multiply-adds differently. In
the full configuration (right matcher, speckle filter and WLS) the matcher
outputs and the confidence are bitwise, the filtered disparity within the
WLS bound of tests/test_torch_wls.py, and xyz and the stats are held to
the JAX functions applied to the port's own disparity, so that the two
tolerances do not compound."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereo_depth_ruler_tpu import pipeline as jp
from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.io.synthetic import make_scene, render_stereo_pair
from stereo_depth_ruler_tpu.metrics import batch_frame_stats
from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops.reproject import reproject_to_3d
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch import StereoRig as TorchRig
from stereo_depth_ruler_tpu_torch import pipeline as tp
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as tc
from stereo_depth_ruler_tpu_torch.ops.remap import RemapGrid

PARAMS = SGBMParams(num_disparities=16, block_size=5, speckle_window_size=0)
RTOL = 1e-5
WLS_RTOL, WLS_ATOL = 2e-3, 2e-2
RIG = dict(width=64, height=48, focal=60.0, baseline_mm=40.0)


@pytest.fixture(scope="module")
def rig():
    return StereoRig.synthetic(**RIG)


@pytest.fixture(scope="module")
def frames(rig):
    """Two seeded uint8 frame pairs, the second with the boxes moved."""
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 500.0),
                       background_z_mm=900.0, seed=2)
    pairs = [render_stereo_pair(scene, seed=2, shift=(2.0 * i, 0.0))
             for i in range(2)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def make_pair(rig, **cfg):
    jcfg = dict(cfg, sgbm=JaxParams(**dataclasses.asdict(cfg["sgbm"])))
    pj = jp.StereoPipeline(rig, jp.PipelineConfig(matcher="jnp", **jcfg))
    grids = tuple(RemapGrid.from_arrays(np.asarray(g.idx00), np.asarray(g.wx),
                                        np.asarray(g.wy), np.asarray(g.valid),
                                        g.src_shape, "cpu")
                  for g in (pj.grid_l, pj.grid_r))
    pt = tp.StereoPipeline(TorchRig.synthetic(**RIG),
                           tp.PipelineConfig(matcher="jnp", **cfg),
                           device="cpu", grids=grids)
    return pj, pt


def compare(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("disparity", "confidence", "left_rectified",
                 "right_rectified"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("downscale,lr_mode", [(1, "fast"), (2, "none")])
def test_process_batch(rig, frames, downscale, lr_mode):
    pj, pt = make_pair(rig, sgbm=PARAMS, downscale=downscale, use_wls=False,
                       lr_mode=lr_mode)
    lefts, rights = frames
    got = pt.process_batch(lefts, rights)
    compare(got, pj.process_batch(np.float32(lefts), np.float32(rights)))
    assert (got["disparity"] >= 0).float().mean() > 0.5


def test_process_pair_and_sbs(rig, frames):
    # use_wls=True with lr_mode="fast" runs no WLS in either package
    pj, pt = make_pair(rig, sgbm=PARAMS, downscale=1, use_wls=True,
                       lr_mode="fast", remap_precision="f32")
    left, right = frames[0][1], frames[1][1]
    want = pj.process_pair(np.float32(left), np.float32(right))
    compare(pt.process_pair(left, right), want)
    sbs = np.concatenate([left, right], axis=1)
    compare(pt.process_sbs(sbs), want)
    xyz = tp.StereoPipeline.xyz_hwc(pt.process_pair(left, right)["xyz"])
    assert xyz.shape == (rig.height, rig.width, 3)


def test_color_input_matches(rig, frames):
    """BGR frames go through bgr_to_gray first (within the float rtol: the
    gray weights are a float multiply-add)."""
    pj, pt = make_pair(rig, sgbm=PARAMS, downscale=1, use_wls=False,
                       lr_mode="fast", remap_precision="f32")
    bgr = np.stack([frames[0][0]] * 3, axis=-1).astype(np.float32)
    bgr[..., 0] *= 0.5
    got = tp.bgr_to_gray(torch.tensor(bgr)).numpy()
    want = np.asarray(jp.bgr_to_gray(bgr))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert pt.process_pair(bgr, bgr)["disparity"].shape == (rig.height,
                                                            rig.width)


def test_full_configuration(rig, frames):
    """entry_full_pipeline()'s configuration: the right matcher, the
    speckle filter on both matchers, and the WLS filter."""
    params = SGBMParams(num_disparities=16, block_size=5,
                        speckle_window_size=20, speckle_range=2)
    pj, pt = make_pair(rig, sgbm=params, downscale=1, use_wls=True,
                       lr_mode="right_matcher")
    lefts, rights = frames
    got = pt.process_batch(lefts, rights)
    want = pj.process_batch(np.float32(lefts), np.float32(rights))
    assert set(got) == set(want)
    for k in ("left_rectified", "right_rectified", "confidence"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)

    # the matcher outputs: the port's pair, the pipeline's stacked call
    # and the JAX pair, bitwise
    lrect, rrect = got["left_rectified"], got["right_rectified"]
    dl, dr = ts.compute_disparity_pair(lrect, rrect, params)
    dd = tc.sgbm_cuda(torch.cat([lrect, rrect.flip(-1)]),
                      torch.cat([rrect, lrect.flip(-1)]), params)
    assert torch.equal(dd[:2], dl) and torch.equal(dd[2:].flip(-1), dr)
    jparams = JaxParams(**dataclasses.asdict(params))
    for i in range(2):
        dl_j, dr_j = js.compute_disparity_pair(
            jnp.asarray(lrect[i].numpy()), jnp.asarray(rrect[i].numpy()),
            jparams)
        np.testing.assert_array_equal(dl[i].numpy(), np.asarray(dl_j))
        np.testing.assert_array_equal(dr[i].numpy(), np.asarray(dr_j))
    assert bool((dl >= 0).any()) and bool((dl < 0).any())

    disp, want_disp = got["disparity"].numpy(), np.asarray(want["disparity"])
    np.testing.assert_array_equal(disp < 0, want_disp < 0)
    m = want_disp >= 0
    np.testing.assert_allclose(disp[m], want_disp[m], rtol=WLS_RTOL,
                               atol=WLS_ATOL)
    assert m.mean() > 0.9                       # the WLS filter inpaints

    xyz = reproject_to_3d(jnp.asarray(disp), rig.Q, layout="chw")
    stats = batch_frame_stats(jnp.asarray(disp), xyz[..., 2, :, :],
                              skip_cols=params.num_disparities)
    for k, w in (("xyz", xyz), ("frame_stats", stats)):
        g, w = got[k].numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, err_msg=k)
