"""The port's reprojection and per-frame stats against the JAX package.

rtol 1e-5: XLA and PyTorch may order or contract the multiply-adds of
Q [x y d 1]^T differently, which moves float32 results by a few ulp; the
positions of inf (invalid disparity) must agree exactly."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stereo_depth_ruler_tpu import metrics as jm
from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.ops import reproject as jr
from stereo_depth_ruler_tpu_torch import metrics as tm
from stereo_depth_ruler_tpu_torch.ops import reproject as tr

RTOL = 1e-5


def close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)


@pytest.fixture(scope="module")
def disp():
    """(2, 24, 40) disparities in 0..30 with some invalid (-1) pixels."""
    rng = np.random.default_rng(11)
    d = np.round(rng.uniform(0.5, 30.0, (2, 24, 40)) * 16) / 16
    d[rng.uniform(size=d.shape) < 0.2] = -1.0
    return d.astype(np.float32)


@pytest.fixture(scope="module")
def Q():
    return StereoRig.synthetic(width=40, height=24, focal=35.0,
                               baseline_mm=60.0).Q


@pytest.mark.parametrize("layout,scale,quirk,missing,offsets", [
    ("hwc", 1.0, False, False, (0, 0)),
    ("chw", 1.0, False, True, (0, 0)),
    ("chw", 0.5, False, False, (0, 0)),
    ("hwc", 0.5, True, False, (0, 0)),
    ("hwc", 1.0, False, False, (7, 13)),
])
def test_reproject_to_3d(disp, Q, layout, scale, quirk, missing, offsets):
    kw = dict(scale=scale, quirk_compat=quirk, handle_missing=missing,
              row_offset=offsets[0], col_offset=offsets[1], layout=layout)
    close(tr.reproject_to_3d(torch.tensor(disp), Q, **kw),
          jr.reproject_to_3d(jnp.asarray(disp), Q, **kw))


def test_depth_from_disparity_and_scale_q(disp, Q):
    close(tr.depth_from_disparity(torch.tensor(disp), Q, scale=0.5),
          jr.depth_from_disparity(jnp.asarray(disp), Q, scale=0.5))
    np.testing.assert_array_equal(tr.scale_q(Q, 0.25), jr.scale_q(Q, 0.25))


def test_batch_frame_stats(disp, Q):
    z_t = tr.reproject_to_3d(torch.tensor(disp), Q)[..., 2]
    z_j = jr.reproject_to_3d(jnp.asarray(disp), Q)[..., 2]
    close(tm.batch_frame_stats(torch.tensor(disp), z_t, skip_cols=8,
                               z_max=3000.0),
          jm.batch_frame_stats(jnp.asarray(disp), z_j, skip_cols=8,
                               z_max=3000.0))


def test_batch_frame_stats_fractions_bitwise():
    """The valid fraction and the depth coverage equal the JAX pipeline's
    (its jitted batch_frame_stats) bit for bit at every count of a 12x16
    frame: XLA multiplies a count by the float32 reciprocal of the pixel
    count, which a true division misses by an ulp for some counts."""
    import jax
    H, W = 12, 16
    k = np.arange(H * W + 1)
    on = (np.arange(H * W)[None, :] < k[:, None]).reshape(-1, H, W)
    disp = np.where(on, 5.0, -1.0).astype(np.float32)
    z = np.where(on, 800.0, np.inf).astype(np.float32)
    want = np.asarray(jax.jit(jm.batch_frame_stats)(jnp.asarray(disp),
                                                    jnp.asarray(z)))
    got = tm.batch_frame_stats(torch.tensor(disp), torch.tensor(z)).numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_array_equal(got, want)
