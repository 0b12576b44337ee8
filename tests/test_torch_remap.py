"""The port's rectification against the JAX package on a distorted
synthetic rig.

atol 1e-3 on 0..255 values: both compute the bilinear lerp in float32, but
XLA may contract its multiply-adds into FMAs where PyTorch does not."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.ops import remap as jrm
from stereo_depth_ruler_tpu_torch.ops import remap as trm

ATOL = 1e-3


@pytest.fixture(scope="module")
def rig():
    return StereoRig.synthetic(width=64, height=40, focal=60.0,
                               baseline_mm=50.0, distortion=True)


@pytest.fixture(scope="module")
def grids(rig):
    return jrm.build_remap_grids(rig), trm.build_remap_grids(rig, "cpu")


@pytest.fixture(scope="module")
def imgs(rig):
    """(2, H, W) float images in 0..255 with fractional values."""
    rng = np.random.default_rng(5)
    return rng.uniform(-3.0, 258.0, (2, rig.height, rig.width)).astype(
        np.float32)


def test_compute_rectify_map_is_the_same(rig):
    args = (rig.camera_matrix_left, rig.dist_coeffs_left, rig.R1, rig.P1,
            rig.image_size)
    for a, b in zip(trm.compute_rectify_map(*args),
                    jrm.compute_rectify_map(*args)):
        np.testing.assert_array_equal(a, b)


def test_grids_are_the_same(grids):
    (jl, jr_), (tl, tr_) = grids
    for j, t in ((jl, tl), (jr_, tr_)):
        assert t.src_shape == j.src_shape
        for name in ("idx00", "wx", "wy", "valid"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))


@pytest.mark.parametrize("precision", ["f32", "u8"])
def test_remap_bilinear(grids, imgs, precision):
    (jl, _), (tl, _) = grids
    want = np.asarray(jrm.remap_bilinear(jnp.asarray(imgs), jl, precision))
    got = trm.remap_bilinear(torch.tensor(imgs), tl, precision).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (want == 0).mean() < 0.5      # the grid samples real pixels


def test_rectify_pair_and_from_arrays(grids, imgs):
    (jl, jr_), _ = grids
    carried = [trm.RemapGrid.from_arrays(np.asarray(g.idx00),
                                         np.asarray(g.wx), np.asarray(g.wy),
                                         np.asarray(g.valid), g.src_shape,
                                         "cpu") for g in (jl, jr_)]
    want = jrm.rectify_pair(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                            jl, jr_)
    got = trm.rectify_pair(torch.tensor(imgs[0]), torch.tensor(imgs[1]),
                           *carried)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
