"""The CUDA kernels against their plain versions on the card, bitwise.

Marked ``cuda``: they need a CUDA card and nvcc, and skip without them.
The file needs nothing from tests/conftest.py (which imports JAX), so on a
machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

import torch

from stereo_depth_ruler_tpu.io.synthetic import make_scene, render_stereo_pair
from stereo_depth_ruler_tpu.ops.sgbm_ref import sgbm_numpy
from stereo_depth_ruler_tpu_torch import StereoRig
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def pair(H, W, D, seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -(D // 3), axis=2)
                    + rng.normal(0, 2, left.shape), 0, 255)
    return left, right.astype(np.float32)


@pytest.mark.parametrize("H,W,kw", [
    (32, 48, dict(num_disparities=16)),
    (40, 72, dict(num_disparities=48, min_disparity=3)),
    (24, 40, dict(num_disparities=64)),                    # W < D
    (48, 300, dict(num_disparities=256, min_disparity=5, block_size=7)),
    (36, 100, dict(num_disparities=32, block_size=3, uniqueness_ratio=0,
                   quantize_16=False, disp12_max_diff=-1)),
    (30, 90, dict(num_disparities=80, block_size=11, disp12_max_diff=0,
                  p1=100, p2=1500)),
])
def test_kernels_match_plain(cuda, H, W, kw):
    params = SGBMParams(speckle_window_size=0, **kw)
    D = params.num_disparities
    left, right = pair(H, W, D, seed=H)
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), 63)
    C = sc.cost_volume(lt, rt, params)
    torch.cuda.synchronize()
    C_p = plain.cost_volume(lt, rt, params)
    assert torch.equal(C.float(), C_p)
    S = sc.aggregate(C, params)
    torch.cuda.synchronize()
    S_p = plain.aggregate_paths(C_p, params.P1, params.P2, 8)
    assert torch.equal(S.float(), S_p)
    for apply_lr in (True, False):
        got = sc.wta_lr(S, params, apply_lr)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.wta_lr(S_p, params, apply_lr))


def test_matcher_matches_numpy_oracle(cuda):
    rig = StereoRig.synthetic(width=48, height=32, focal=50.0,
                              baseline_mm=30.0)
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 400.0),
                       background_z_mm=700.0, seed=1)
    left, right, _ = render_stereo_pair(scene, seed=1)
    params = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                        speckle_window_size=0)
    got = sc.sgbm_cuda(torch.tensor(np.float32(left[None]), device=cuda),
                       torch.tensor(np.float32(right[None]), device=cuda),
                       params)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  sgbm_numpy(left, right, params))
