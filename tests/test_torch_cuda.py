"""The CUDA kernels against their plain versions on the card, bitwise (the
FGS pass too: its plain version divides as IEEE division does). The sort
family's plain sorts are torch.sort(stable=True), which the radix sort
matches in values as well as keys, being stable too.

Marked ``cuda``: they need a CUDA card and nvcc, and skip without them.
The file needs nothing from tests/conftest.py (which imports JAX), so on a
machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

import torch

from stereo_depth_ruler_tpu_torch.io.synthetic import make_scene, render_stereo_pair
from stereo_depth_ruler_tpu_torch.ops.sgbm_ref import sgbm_numpy
from stereo_depth_ruler_tpu_torch import StereoRig
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.ops import sort as sortp
from stereo_depth_ruler_tpu_torch.ops import sort_cuda
from stereo_depth_ruler_tpu_torch.ops import wls as wplain
from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc

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


@pytest.mark.parametrize("H,W,kw", [
    (32, 48, dict(num_disparities=16)),
    (40, 72, dict(num_disparities=48, block_size=1)),      # r = 0
    (24, 24, dict(num_disparities=16)),                    # all band
    (36, 100, dict(num_disparities=32, block_size=7, min_disparity=3,
                   quantize_16=False)),
])
def test_pair_modes_match_plain(cuda, H, W, kw):
    """K1's pair mode and K3's mirror mode against their plain versions;
    then the shared pair against the stacked one."""
    params = SGBMParams(speckle_window_size=0, **kw)
    D = params.num_disparities
    left, right = pair(H, W, D, seed=W)
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), 63)
    C = sc.cost_volume_pair(lt, rt, params)
    torch.cuda.synchronize()
    C_L, C_R = plain.cost_volume_pair(lt, rt, params)
    assert torch.equal(C.float(), torch.cat([C_L, C_R]))
    S = sc.aggregate(C, params)
    torch.cuda.synchronize()
    S_p = S.float()
    for apply_lr in (True, False):
        got = sc.wta_lr(S, params, apply_lr, mirror_from=2)
        torch.cuda.synchronize()
        assert torch.equal(got[:2], plain.wta_lr(S_p[:2], params, apply_lr))
        assert torch.equal(got[2:], plain.wta_lr(S_p[2:], params, apply_lr,
                                                 mirror_lr=True))
    if params.min_disparity == 0:
        l, r = torch.tensor(left, device=cuda), torch.tensor(right,
                                                             device=cuda)
        params = SGBMParams(speckle_window_size=20, **kw)
        dl, dr = sc.sgbm_pair_cuda(l, r, params)
        dd = sc.sgbm_cuda(torch.cat([l, r.flip(-1)]),
                          torch.cat([r, l.flip(-1)]), params)
        assert torch.equal(dl, dd[:2]) and torch.equal(dr, dd[2:].flip(-1))


@pytest.mark.parametrize("speckle", [0, 20])
def test_matcher_matches_numpy_oracle(cuda, speckle):
    rig = StereoRig.synthetic(width=48, height=32, focal=50.0,
                              baseline_mm=30.0)
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 400.0),
                       background_z_mm=700.0, seed=1)
    left, right, _ = render_stereo_pair(scene, seed=1)
    params = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                        speckle_window_size=speckle, speckle_range=2)
    got = sc.sgbm_cuda(torch.tensor(np.float32(left[None]), device=cuda),
                       torch.tensor(np.float32(right[None]), device=cuda),
                       params)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  sgbm_numpy(left, right, params))


def serpentine(H, W, pitch=2):
    """One 1-px-wide snake over the image: H / (2 pitch) double turns."""
    disp = -np.ones((H, W), np.float32)
    for r in range(0, H, 2 * pitch):
        disp[r, :] = 5.0
        if r + 2 * pitch < H:
            disp[r:r + 2 * pitch + 1,
                 W - 1 if (r // (2 * pitch)) % 2 == 0 else 0] = 5.0
    return disp


def noisy(H, W, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, (2, H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.25] = -1.0
    d[:, H // 4:H // 2, W // 4:W // 2] = 7.5
    return d


@pytest.mark.parametrize("case", ["noisy", "serpentine", "all_invalid"])
def test_speckle_kernels_match_plain(cuda, case):
    if case == "noisy":
        d = noisy(96, 160, seed=3)
    elif case == "serpentine":
        s = serpentine(256, 384)
        d = np.stack([s, s[::-1, ::-1]])
    else:
        d = np.full((2, 40, 64), -1.0, np.float32)
    disp = torch.tensor(np.ascontiguousarray(d), device=cuda)
    for max_size in (4, 40):
        labels = sc.speckle_labels(disp, 1.0)
        torch.cuda.synchronize()
        assert torch.equal(labels, plain.speckle_labels(disp, 1.0))
        kept = sc.speckle_keep(disp, labels, max_size)
        torch.cuda.synchronize()
        assert torch.equal(kept, plain.speckle_keep(disp, labels, max_size))
    if case == "serpentine":
        assert torch.unique(labels[0][disp[0] >= 0]).numel() == 1
    capped = sc.speckle_labels(disp, 1.0, max_iters=3)
    torch.cuda.synchronize()
    assert torch.equal(capped, plain.speckle_labels(disp, 1.0, 3))


def speckle_map(case):
    if case == "noisy":
        d = noisy(96, 160, seed=5)
    elif case == "serpentine":
        s = serpentine(256, 384)
        d = np.stack([s, s[::-1, ::-1]])
    else:
        d = np.full((2, 40, 64), -1.0, np.float32)
    return torch.tensor(np.ascontiguousarray(d), device="cuda")


@pytest.mark.parametrize("case", ["noisy", "serpentine", "all_invalid"])
def test_sweep_kernel_matches_plain(cuda, case):
    """The sweep kernel's labels mode round for round (capped at 1-3) and
    converged (equal to K4's union-find), its propagate mode capped and
    converged, and the seeded keep on top, all bitwise."""
    disp = speckle_map(case)
    for max_iters in (1, 2, 3, 0):
        got = sc.sweep_labels(disp, 1.0, max_iters)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.speckle_labels(disp, 1.0, max_iters))
    labels = sc.speckle_labels(disp, 1.0)
    assert torch.equal(got, labels)
    g = torch.Generator(device="cuda").manual_seed(3)
    seed = (torch.rand(labels.shape, generator=g, device=cuda)
            < 0.01).to(torch.int32)
    for max_iters in (1, 2, 0):
        got = sc.propagate_keep(labels, seed, max_iters)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.propagate_keep(labels, seed, max_iters))
    for max_size in (4, 40):
        keep = sc.speckle_keep_seeded(labels, max_size)
        torch.cuda.synchronize()
        assert torch.equal(keep, plain.speckle_keep_seeded(labels, max_size))
        assert torch.equal(keep, sc.speckle_keep(disp, labels, max_size) >= 0)


@pytest.mark.parametrize("case", ["noisy", "serpentine", "all_invalid"])
def test_sort_kernels_match_plain(cuda, case):
    """The radix sort (keys, pairs) and the sorted-run kernel (sizes, keep,
    roots) on the packed labels of a map, and the functions built on them,
    bitwise against their plain versions."""
    disp = speckle_map(case)
    labels = sc.speckle_labels(disp, 1.0)
    key, n, n2, L, R = sortp.pack_batched(labels)
    skey = sort_cuda.sort_keys(key)
    torch.cuda.synchronize()
    assert torch.equal(skey, sortp.sort_keys(key))
    g = torch.Generator(device="cuda").manual_seed(4)
    val = torch.randint(0, 2 ** 31 - 1, key.shape, generator=g, device=cuda,
                        dtype=torch.int32)
    for v in (val, sortp.positions(key)):
        got = sort_cuda.sort_pairs(key, v)
        torch.cuda.synchronize()
        want = sortp.sort_pairs(key, v)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    sidx = got[1]
    assert torch.equal(sort_cuda.run_sizes(skey), sortp.run_sizes(skey))
    assert torch.equal(sort_cuda.run_sizes(skey, sidx, n),
                       sortp.run_sizes(skey, sidx, n))
    for max_size in (1, 4, 40):
        assert torch.equal(sort_cuda.run_keep(skey, sidx, n, max_size),
                           sortp.run_keep(skey, sidx, n, max_size))
        assert torch.equal(sort_cuda.speckle_keep_sorted(labels, max_size),
                           sortp.speckle_keep_sorted(labels, max_size))
    for max_size in (3, 8, 50):
        assert torch.equal(sort_cuda.large_run_roots(skey, n2, L, max_size),
                           sortp.large_run_roots(skey, n2, L, max_size))
    assert torch.equal(sort_cuda.equal_value_counts(labels),
                       sortp.equal_value_counts(labels))
    for max_iters in (1, 3):
        got = sc.speckle_filter(disp, 40, 1.0, max_iters)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.speckle_filter(disp, disp >= 0, 40, 1.0,
                                                     max_iters))


@pytest.mark.parametrize("B,N", [(1, 1), (3, 777), (2, 2048 * 3 + 5),
                                 (2, 1 << 20)])
def test_radix_sort_any_length(cuda, B, N):
    """Keys over the whole [0, 2**31) range and keys with many ties, at
    lengths that are not a multiple of the kernel's tile."""
    g = torch.Generator(device="cuda").manual_seed(N)
    for hi in (2 ** 31 - 1, 50):
        key = torch.randint(0, hi, (B, N), generator=g, device=cuda,
                            dtype=torch.int32)
        val = torch.arange(B * N, device=cuda, dtype=torch.int32).reshape(B, N)
        skey, sval = sort_cuda.sort_pairs(key, val)
        torch.cuda.synchronize()
        want, idx = torch.sort(key, dim=1, stable=True)
        assert torch.equal(skey, want)
        assert torch.equal(sval, torch.gather(val, 1, idx))
        assert torch.equal(sort_cuda.sort_keys(key), want)


def banded(H, W, seed):
    rng = np.random.default_rng(seed)
    base = 4.0 + 2.0 * ((np.arange(H) * 12) // H)[None, :, None]
    dl = np.float32(base + rng.normal(0, 0.4, (2, H, W)))
    dl[rng.uniform(size=dl.shape) < 0.2] = -1.0
    dl[0, 3, 10], dl[0, 3, 11] = 2.5, 3.5        # exact halves
    dr = np.float32(base + rng.normal(0, 0.6, (2, H, W)))
    dr[rng.uniform(size=dr.shape) < 0.1] = -1.0
    guide = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    return dl, dr, guide


@pytest.mark.parametrize("H,W", [(40, 64), (96, 300)])
def test_wls_kernels_match_plain(cuda, H, W):
    dl, dr, guide = (torch.tensor(a, device=cuda) for a in banded(H, W, H))
    rhs = wc.shift_gather_conf(dl, dr, 32)
    torch.cuda.synchronize()
    assert torch.equal(rhs, wplain.shift_gather_conf(dl, dr, 32))
    for axis in (-1, -2):
        got = wc.fgs_pass(rhs, guide, 2000.0, 1.1, axis)
        torch.cuda.synchronize()
        assert torch.equal(got, wplain.fgs_pass(rhs, guide, 2000.0, 1.1,
                                                axis))
    f, conf = wc.wls_disparity_filter_cuda(dl, dr, guide, max_disp=32)
    f_p, conf_p = wplain.wls_disparity_filter(dl, dr, guide, max_disp=32)
    assert torch.equal(conf, conf_p)
    assert torch.equal(f, f_p)


@pytest.mark.parametrize("H,W,kw", [
    (32, 48, dict(num_disparities=16)),
    (40, 72, dict(num_disparities=48, min_disparity=3)),
    (24, 40, dict(num_disparities=64, num_paths=4)),       # W < D
    (48, 300, dict(num_disparities=256, min_disparity=5, num_paths=2)),
    (36, 100, dict(num_disparities=32, block_size=3, uniqueness_ratio=0,
                   quantize_16=False, disp12_max_diff=-1)),
    (30, 90, dict(num_disparities=80, block_size=1, p1=8, p2=32)),
    (1, 50, dict(num_disparities=16)),                     # one row
])
def test_staged_kernels_match_plain(cuda, H, W, kw):
    """The fused cost + down kernel, K2 on an int16 S and the three-input
    WTA/LR against their plain versions and against K1-K3, bitwise."""
    params = SGBMParams(speckle_window_size=0, **kw)
    D = params.num_disparities
    left, right = pair(H, W, D, seed=H)
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), 63)
    C, S_down = sc.cost_down(lt, rt, params)
    torch.cuda.synchronize()
    C_p, S_down_p = plain.cost_down(lt, rt, params)
    assert C.dtype == S_down.dtype == torch.int16
    assert torch.equal(C.float(), C_p)
    assert torch.equal(S_down.float(), S_down_p)
    assert torch.equal(C, sc.cost_volume(lt, rt, params))
    up = plain.up_dirs(params.num_paths)
    S_h = sc.aggregate_i16(C, params, [(0, 1), (0, -1)])
    S_up = sc.aggregate_i16(C, params, up)
    torch.cuda.synchronize()
    S32 = torch.empty(C.shape, dtype=torch.int32, device=cuda)
    for i, (dy, dx) in enumerate(up):
        sc.sgm_pass(C, S32, dy, dx, params.P1, params.P2, i > 0)
    assert S_up.dtype == torch.int16 and torch.equal(S_up.int(), S32)
    for apply_lr in (True, False):
        got = sc.wta_lr3(S_down, S_up, S_h, params, apply_lr)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.wta_lr3(S_down, S_up, S_h, params,
                                              apply_lr))
        if params.num_paths >= 4:
            assert torch.equal(got, sc.wta_lr(sc.aggregate(C, params), params,
                                              apply_lr))


@pytest.mark.parametrize("speckle", [0, 20])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_staged_matcher_matches_fused(cuda, num_paths, speckle):
    params = SGBMParams(num_disparities=32, speckle_window_size=speckle,
                        speckle_range=2, num_paths=num_paths)
    left, right = (torch.tensor(a, device=cuda) for a in pair(60, 140, 32, 9))
    got = sc.sgbm_staged_cuda(left, right, params)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.sgbm_cuda(left, right, params))
    assert torch.equal(got, plain.sgbm_staged(left, right, params))
    with pytest.raises(ValueError, match="int16"):
        sc.sgbm_staged_cuda(left, right, SGBMParams(num_disparities=32,
                                                    block_size=7))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 8, 24), (70, 5, 131), (3, 33, 1),
                                   (128, 40, 96)])
def test_transposes_match_permute(cuda, dtype, shape):
    """The three transposes against permute().contiguous(), bit for bit
    (compared as integers, so a NaN pattern counts too), and there and
    back; extents that divide no tile."""
    g = torch.Generator(device="cuda").manual_seed(shape[0])
    nbits = torch.empty((), dtype=dtype).element_size() * 8
    ibits = torch.int16 if nbits == 16 else torch.int32
    x = torch.randint(-2 ** (nbits - 1), 2 ** (nbits - 1) - 1, shape,
                      generator=g, device=cuda,
                      dtype=torch.int64).to(ibits).view(dtype)
    for fn, fn_p in ((sc.transpose_vol, plain.transpose_vol),
                     (sc.transpose_leading, plain.transpose_leading),
                     (sc.transpose_dhw_to_wdh, plain.transpose_dhw_to_wdh)):
        got = fn(x)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got.view(ibits), fn_p(x).view(ibits))
    assert torch.equal(sc.transpose_vol(sc.transpose_vol(x)).view(ibits),
                       x.view(ibits))
    assert torch.equal(
        sc.transpose_leading(sc.transpose_leading(x)).view(ibits),
        x.view(ibits))
    y = sc.transpose_dhw_to_wdh
    assert torch.equal(y(y(y(x))).view(ibits), x.view(ibits))
