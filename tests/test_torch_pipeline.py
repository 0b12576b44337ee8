"""The port's StereoPipeline against the JAX StereoPipeline (jnp matcher)
on the undistorted synthetic rig, both fed the same numpy frames and the
same rectification tables (the JAX grids carried across with
RemapGrid.from_arrays).

Disparity is compared bitwise; xyz and the stats at rtol 1e-5, since XLA
and PyTorch may order or contract the float multiply-adds differently."""

import numpy as np
import pytest

import torch

from stereo_depth_ruler_tpu import pipeline as jp
from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.io.synthetic import make_scene, render_stereo_pair
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch import pipeline as tp
from stereo_depth_ruler_tpu_torch.ops.remap import RemapGrid

PARAMS = SGBMParams(num_disparities=16, block_size=5, speckle_window_size=0)
RTOL = 1e-5


@pytest.fixture(scope="module")
def rig():
    return StereoRig.synthetic(width=64, height=48, focal=60.0,
                               baseline_mm=40.0)


@pytest.fixture(scope="module")
def frames(rig):
    """Two seeded uint8 frame pairs, the second with the boxes moved."""
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 500.0),
                       background_z_mm=900.0, seed=2)
    pairs = [render_stereo_pair(scene, seed=2, shift=(2.0 * i, 0.0))
             for i in range(2)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def make_pair(rig, **cfg):
    pj = jp.StereoPipeline(rig, jp.PipelineConfig(matcher="jnp", **cfg))
    grids = tuple(RemapGrid.from_arrays(np.asarray(g.idx00), np.asarray(g.wx),
                                        np.asarray(g.wy), np.asarray(g.valid),
                                        g.src_shape, "cpu")
                  for g in (pj.grid_l, pj.grid_r))
    pt = tp.StereoPipeline(rig, tp.PipelineConfig(matcher="jnp", **cfg),
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
