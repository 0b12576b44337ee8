"""The CUDA kernels against their plain versions on the card, bitwise (the
FGS pass too: its plain version, the Thomas solve, divides as IEEE
division does). The sort family's plain sorts are
torch.sort(stable=True), which the radix sort matches in values as well
as keys, being stable too.

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


@pytest.mark.parametrize("H,W,D,md", [
    (3, 20, 16, 0),        # H below most blocks, W below one column tile
    (130, 100, 16, 3),     # H not a multiple of the row strip, ragged W
    (70, 45, 256, 0),      # two strips, ragged W, the widest D
    (2, 300, 256, 3),
])
@pytest.mark.parametrize("block", [1, 3, 5, 7, 9, 11])
def test_cost_box_every_block_matches_plain(cuda, block, H, W, D, md):
    """K1 (the row-sliding box) against ops/sgbm.py:cost_volume, bitwise,
    at every block size, with strips, tiles and the clamped rows and
    columns at every border."""
    params = SGBMParams(num_disparities=D, min_disparity=md,
                        block_size=block, speckle_window_size=0)
    left, right = pair(H, W, D, seed=H + W + block)
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), 63)
    C = sc.cost_volume(lt, rt, params)
    torch.cuda.synchronize()
    assert C.dtype == torch.int16
    assert torch.equal(C.float(), plain.cost_volume(lt, rt, params))


@pytest.mark.parametrize("H,W,D,md", [
    (3, 20, 16, 0),
    (130, 100, 16, 3),
    (70, 45, 256, 0),
    (2, 300, 256, 3),
])
@pytest.mark.parametrize("block", [1, 3, 5, 7, 9, 11])
def test_cost_pair_every_block_matches_plain(cuda, block, H, W, D, md):
    """K1's pair mode (the C_L and the C_R tiles of one launch) against
    ops/sgbm.py:cost_volume_pair, bitwise, at every block size and the
    shapes of the single-volume test."""
    params = SGBMParams(num_disparities=D, min_disparity=md,
                        block_size=block, speckle_window_size=0)
    left, right = pair(H, W, D, seed=H + W + block + 1)
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), 63)
    C = sc.cost_volume_pair(lt, rt, params)
    torch.cuda.synchronize()
    assert C.dtype == torch.int16
    assert torch.equal(C.float(), torch.cat(plain.cost_volume_pair(lt, rt,
                                                                   params)))


@pytest.mark.parametrize("B,H,W,D,md,block", [
    (2, 24, 40, 64, 0, 5),      # W < D: every C_R column in the band
    (2, 24, 30, 32, 2, 7),      # W < D + md
    (2, 33, 35, 32, 0, 5),      # W = D + md + r + 1: the band's edge
    (2, 33, 34, 32, 0, 5),      # W = D + md + r
    (2, 33, 33, 32, 0, 5),      # W = D + md + r - 1
    (2, 17, 147, 128, 16, 9),   # W = D + md + r - 1, md > 0
    (2, 10, 200, 48, 1, 3),     # H below one strip of rows
    (16, 20, 96, 32, 0, 5),     # 16 frames
])
def test_cost_pair_band_edges(cuda, B, H, W, D, md, block):
    """K1's pair mode where every C_R column lies in the TPU kernel's
    border band (W < D), around the band's first column (W = D + md + r
    and one either side), on fewer rows than one strip and on 16 frames,
    bitwise."""
    params = SGBMParams(num_disparities=D, min_disparity=md,
                        block_size=block, speckle_window_size=0)
    rng = np.random.default_rng(B + H + W)
    left = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -(D // 3), axis=2)
                    + rng.normal(0, 2, left.shape), 0, 255).astype(np.float32)
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), 63)
    C = sc.cost_volume_pair(lt, rt, params)
    torch.cuda.synchronize()
    assert torch.equal(C.float(), torch.cat(plain.cost_volume_pair(lt, rt,
                                                                   params)))


@pytest.mark.parametrize("B,H,W", [
    (2, 5, 1), (2, 1, 5), (2, 5, 2), (2, 2, 5), (2, 5, 3), (2, 3, 5),
    (2, 5, 720), (2, 720, 5), (2, 5, 1280), (2, 1280, 5), (2, 5, 7168),
    (2, 7168, 5),
    (1, 720, 1280), (8, 720, 1280),        # the live and the batch cells
    (1, 33, 721), (3, 721, 33),            # lines off every plan's tile
    (1, 45, 1278), (8, 130, 42),           # W % 4 != 0
])
def test_fgs_pass_any_length(cuda, B, H, W):
    """K6 (the Thomas recurrence from both ends of each line) against its
    plain version, bitwise, along rows (lines of W) and columns (lines of
    H) of (B, 2, H, W) right-hand sides, at each of the filter's three
    lambdas, on a random and a step-edge guide; each launch under the
    plan that fills the card: 8 lines a block, 4 in a row pass whose B
    frames of H rows would leave a multiprocessor without a block of 8."""
    rng = np.random.default_rng(B * H * W)
    rhs = torch.tensor(rng.uniform(0, 64, (B, 2, H, W)).astype(np.float32),
                       device=cuda)
    step = np.zeros((B, H, W), np.float32)
    step[:, :, W // 2:] += 255.0
    step[:, H // 2:, :] += 28.0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for axis, lines in ((-1, H), (-2, W)):
        tile = 4 if axis == -1 and B * -(-lines // 8) < sms else 8
        for g in (rng.uniform(0, 255, (B, H, W)).astype(np.float32), step):
            guide = torch.tensor(g, device=cuda)
            for lam in wplain.fgs_lambdas(8000.0, 3):
                wc.reset_fgs_plans()
                got = wc.fgs_pass(rhs, guide, lam, 1.1, axis)
                torch.cuda.synchronize()
                assert wc.FGS_PLANS == {k: int(k == f"lines{tile}")
                                        for k in wc.FGS_PLANS}
                assert torch.equal(got, wplain.fgs_pass(rhs, guide, lam, 1.1,
                                                        axis))


def test_kernel_limits_hold_on_cuda(cuda):
    """The kernels' parameter limits, which the CPU path does not have."""
    left, right = (torch.tensor(a, device=cuda) for a in pair(16, 64, 8, 1))
    for kw in (dict(num_disparities=40), dict(min_disparity=-1)):
        with pytest.raises(ValueError):
            sc.sgbm_cuda(left, right, SGBMParams(**kw))


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


def noisy(H, W, seed, B=2):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, (B, H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.25] = -1.0
    d[:, H // 4:H // 2, W // 4:W // 2] = 7.5
    return d


def comb(H, W, pitch=3):
    """A spine along the top row and a tooth down every pitch-th column,
    disparities alternating by half a pixel from row to row: the teeth
    cross every tile border, and below the first tile row a tile's
    pieces (its teeth) meet only through links across its borders."""
    d = -np.ones((H, W), np.float32)
    d[:, ::pitch] = 2.0 + 0.5 * (np.arange(H) % 2)[:, None]
    d[0, :] = 2.0
    return d


def staircase(H, W):
    """A diagonal staircase one pixel wide: row y holds (y, y) and
    (y, y + 1), columns modulo W, disparities stepping by half a pixel or
    one, so each row's run meets the next only through one vertical step."""
    d = -np.ones((H, W), np.float32)
    for y in range(H):
        d[y, [y % W, (y + 1) % W]] = 1.0 + 0.5 * (y % 3)
    return d


def speckle_case(case):
    """(B, H, W) float32 disparities of a K4/K5 test case."""
    if case == "noisy":
        return noisy(96, 160, seed=3)
    if case == "serpentine":
        s = serpentine(256, 384)
        return np.stack([s, s[::-1, ::-1]])
    if case == "all_invalid":
        return np.full((2, 40, 64), -1.0, np.float32)
    if case == "comb":
        c = comb(200, 400)
        return np.stack([c, c[::-1, ::-1]])
    if case == "staircase":
        s = staircase(256, 384)
        return np.stack([s, s[::-1]])
    if case == "constant":
        return np.full((2, 200, 300), 3.0, np.float32)
    if case == "row":
        return noisy(1, 1000, seed=4)
    if case == "column":
        return noisy(1000, 1, seed=5)
    if case == "pixel":
        return np.array([[[2.0]], [[-1.0]]], np.float32)
    if case == "ragged":    # H and W not multiples of the tile
        return noisy(77, 261, seed=6)
    if case == "batch1":
        return noisy(96, 160, seed=7, B=1)
    if case == "batch16":
        return noisy(720, 1280, seed=8, B=16)
    assert case == "nan"
    d = noisy(96, 160, seed=9)
    d[np.random.default_rng(9).uniform(size=d.shape) < 0.1] = np.nan
    return d


@pytest.mark.parametrize("case", [
    "noisy", "serpentine", "all_invalid", "comb", "staircase", "constant",
    "row", "column", "pixel", "ragged", "batch1", "batch16", "nan"])
def test_speckle_kernels_match_plain(cuda, case):
    disp = torch.tensor(np.ascontiguousarray(speckle_case(case)),
                        device=cuda)
    for max_size in (4, 40, 200):
        labels = sc.speckle_labels(disp, 1.0)
        torch.cuda.synchronize()
        assert torch.equal(labels, plain.speckle_labels(disp, 1.0))
        kept = sc.speckle_keep(disp, labels, max_size)
        torch.cuda.synchronize()
        assert torch.equal(kept, plain.speckle_keep(disp, labels, max_size))
    if case in ("serpentine", "comb", "staircase", "constant"):
        # the first frame is one component
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


def vertical_serpentine(H, W, pitch=2):
    """One 1-px-wide snake of vertical runs, each the full height: every
    run crosses every row chunk of the column pass."""
    disp = -np.ones((H, W), np.float32)
    for c in range(0, W, 2 * pitch):
        disp[:, c] = 5.0
        if c + 2 * pitch < W:
            r = H - 1 if (c // (2 * pitch)) % 2 == 0 else 0
            disp[r, c:c + 2 * pitch + 1] = 5.0
    return disp


def sweep_case(case):
    if case == "one_row":
        d = noisy(1, 2000, seed=7)
    elif case == "one_column":
        d = noisy(1500, 1, seed=8)
    elif case == "ragged":          # no chunk of rows, and not 32, divides
        d = noisy(1061, 45, seed=9)
    elif case == "vertical_serpentine":
        s = vertical_serpentine(197, 75)
        d = np.stack([s, s[::-1, ::-1]])
    else:                           # one frame at the stress shape
        d = noisy(1440, 2560, seed=10)[:1]
    return torch.tensor(np.ascontiguousarray(d), device="cuda")


@pytest.mark.parametrize("case", ["one_row", "one_column", "ragged",
                                  "vertical_serpentine", "stress_frame"])
def test_sweep_any_shape(cuda, case):
    """The sweep kernel's two modes at H = 1, W = 1, H and W that no row
    chunk and no 32 divide, on a vertical serpentine whose runs cross
    every chunk boundary, and on one 1440x2560 frame: capped at 1-3 rounds
    and converged, bitwise against their plain versions."""
    disp = sweep_case(case)
    for max_iters in (1, 2, 3, 0):
        got = sc.sweep_labels(disp, 1.0, max_iters)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.speckle_labels(disp, 1.0, max_iters))
    labels = sc.speckle_labels(disp, 1.0)
    assert torch.equal(got, labels)
    g = torch.Generator(device="cuda").manual_seed(4)
    seed = (torch.rand(labels.shape, generator=g, device=cuda)
            < 0.01).to(torch.int32)
    for max_iters in (1, 2, 3, 0):
        got = sc.propagate_keep(labels, seed, max_iters)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.propagate_keep(labels, seed, max_iters))


@pytest.mark.parametrize("case", ["noisy", "serpentine", "all_invalid",
                                  "one_component"])
def test_sort_kernels_match_plain(cuda, case):
    """The radix sort (keys, pairs) and the sorted-run kernel (sizes, keep,
    roots) on the packed labels of a map, and the functions built on them,
    bitwise against their plain versions. One component: every label 0,
    then INF pads."""
    if case == "one_component":
        disp = torch.full((2, 40, 64), 3.0, device=cuda)
    else:
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


TILE = 2048   # sorted_runs.cu's tile of sorted positions (runs_sizes)


def sorted_runs(lengths, first=0, gap=1, n=None):
    """Sorted keys made of runs of the given lengths, the values ``first``,
    ``first + gap``, ...; with ``n``, the first n of them."""
    lengths = np.asarray(lengths)
    if n is not None:
        lengths = lengths[:np.searchsorted(np.cumsum(lengths), n) + 1]
    keys = np.repeat(first + gap * np.arange(len(lengths), dtype=np.int64),
                     lengths)
    return keys[:n]


def runs_case(case):
    """(B, N) sorted int32 keys of a sorted_runs.cu edge case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    T = TILE
    lengths = {"T-1": T - 1, "T": T, "T+1": T + 1, "3T+5": 3 * T + 5,
               "N=1": 1}
    if case in lengths:   # mixed runs, short to longer than a tile
        N = lengths[case]
        keys = [sorted_runs(rng.choice([1, 2, 3, 50, 700, 5000], N),
                            int(rng.integers(0, 100)),
                            int(rng.integers(1, 1000)), N)
                for _ in range(2)]
    elif case == "long_run":    # a run over five tiles, crossing six edges
        N = 9 * T + 7
        keys = [sorted_runs([3, 10, 5 * T + 11, 1, 2, N], n=N),
                sorted_runs([T - 5, 1, 6 * T, N], 4, n=N)]
    elif case == "start_on_last_key":
        # runs starting on tile 0's and tile 1's last key (lengths T and 1)
        N = 5 * T
        keys = [sorted_runs([T - 1, T, 1, 1, T - 3, 2 * T + 2]),
                sorted_runs([2 * T - 1, 1, T, 2 * T], 9)]
    elif case == "distinct":
        N = 3 * T + 5
        keys = [np.arange(N) * 7 + 3, np.arange(N)]
    elif case == "equal":
        N = 3 * T + 5
        keys = [np.full(N, 12345), np.zeros(N)]
    elif case == "first_key_2^30-1":   # position 0 starts no run (roots)
        N = 2 * T
        keys = [sorted_runs([T + 3, T - 3], 2 ** 30 - 1),
                sorted_runs([1, N - 1], 2 ** 30 - 1)]
    elif case == "wide":        # keys anywhere in [0, 2**31)
        N = 2 * T + 3
        keys = [np.sort(np.concatenate([
            rng.integers(0, 2 ** 31 - 1, N - N // 2),
            np.repeat(rng.integers(0, 2 ** 31 - 1, 3), [N // 2 - 2, 1, 1])]))
            for _ in range(2)]
    else:                       # the full path's 16 x 2**20 packed frames
        assert case == "batch16"
        N, n = 1 << 20, 921600
        keys = [np.concatenate([sorted_runs(
            np.minimum(rng.zipf(1.3, n), 200000), 0, 3, n),
            np.full(N - n, 2 ** 30)]) for _ in range(16)]
    return np.stack(keys).astype(np.int32)


@pytest.mark.parametrize("case", [
    "T-1", "T", "T+1", "3T+5", "N=1", "long_run", "start_on_last_key",
    "distinct", "equal", "first_key_2^30-1", "wide", "batch16"])
def test_sorted_runs_edges(cuda, case):
    """The sorted-run kernel's three modes at lengths around its tile of
    2048 positions and N = 1, on runs longer than several tiles, runs that
    start on a tile's last key, all keys distinct or equal, a first key of
    2**30 - 1, keys over [0, 2**31) and 16 x 2**20 keys, against
    ops/sort.py bitwise: sizes with and without source indices (targets
    below 0 and at or past n dropped), keep and roots at max_size 0, 200,
    256, 257 (the largest staged look-ahead and one past it), L and N, at
    the largest L <= 1024 that divides N and at L = N."""
    skey = torch.tensor(runs_case(case), device=cuda)
    B, N = skey.shape
    g = torch.Generator(device="cuda").manual_seed(N)
    perm = torch.argsort(torch.rand((B, N), generator=g, device=cuda),
                         dim=1).to(torch.int32)
    n = max(N - N // 4, 1)
    # targets at or past n are dropped; half of them made negative
    neg = (perm >= n) & (torch.rand((B, N), generator=g, device=cuda) < 0.5)
    sidx = torch.where(neg, -1 - perm, perm)
    got = sort_cuda.run_sizes(skey)
    torch.cuda.synchronize()
    assert torch.equal(got, sortp.run_sizes(skey))
    assert torch.equal(sort_cuda.run_sizes(skey, sidx, n),
                       sortp.run_sizes(skey, perm, n))
    L = max(d for d in range(1, min(N, 1024) + 1) if N % d == 0)
    for max_size in (0, 200, 256, 257, L, N):
        assert torch.equal(sort_cuda.run_keep(skey, sidx, n, max_size),
                           sortp.run_keep(skey, perm, n, max_size))
        for rows in (L, N):
            assert torch.equal(
                sort_cuda.large_run_roots(skey, N, rows, max_size),
                sortp.large_run_roots(skey, N, rows, max_size)), (max_size,
                                                                  rows)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,N", [(1, 1), (3, 777), (2, 4095), (2, 4096),
                                 (2, 4097), (2, 2048 * 3 + 5), (2, 1 << 20),
                                 (16, 1 << 20)])
def test_radix_sort_any_length(cuda, B, N):
    """Keys over the whole [0, 2**31) range, keys with many ties, every key
    equal (every digit skipped), only the top digit varying, labels padded
    with INF as pack_batched pads them, and 2**31 - 1 among small keys; at
    lengths around the kernel's tile of 4096 keys and 16 x 2**20 (the full
    path's 16 packed label frames); keys and values bitwise to
    torch.sort(stable=True)."""
    g = torch.Generator(device="cuda").manual_seed(N)

    def rand(hi):
        return torch.randint(0, hi, (B, N), generator=g, device=cuda,
                             dtype=torch.int32)

    labels = rand(max(N // 8, 1))
    labels[:, N - N // 4:] = sortp.INF
    small = rand(1000)
    small[:, ::7] = 2 ** 31 - 1
    keys = {"wide": rand(2 ** 31 - 1), "ties": rand(50),
            "equal": torch.full((B, N), 12345, dtype=torch.int32,
                                device=cuda),
            "top_digit": rand(128) << 24, "inf_pads": labels, "max": small}
    val = torch.arange(B * N, device=cuda, dtype=torch.int32).reshape(B, N)
    for name, key in keys.items():
        want, idx = torch.sort(key, dim=1, stable=True)
        skey, sval = sort_cuda._radix_sort(key, val)
        torch.cuda.synchronize()
        assert torch.equal(skey, want), name
        assert torch.equal(sval, torch.gather(val, 1, idx)), name
        assert torch.equal(sort_cuda._radix_sort(key, None)[0], want), name
        assert torch.equal(sort_cuda.sort_keys(key), want)
        assert torch.equal(sort_cuda.sort_pairs(key, val)[1],
                           torch.gather(val, 1, idx))


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


@pytest.mark.parametrize("B,H,W", [(1, 24, 64), (8, 17, 128), (1, 9, 37),
                                   (8, 5, 130), (3, 4, 1), (2, 6, 2)])
def test_shift_gather_matches_plain(cuda, B, H, W):
    """K7 (a block a row and frame, the right view's row staged, 4 pixels
    a thread in 16-byte accesses where W % 4 == 0, scalar otherwise)
    against ``ops/wls.py:shift_gather_conf`` bitwise: B = 1 and 8, W not a
    multiple of 4, max_s at its edge (a shift of exactly max_s kept, one
    more dropped), shifts landing on column 0 and past it, exact halves
    (round half to even), invalid pixels on both sides."""
    rng = np.random.default_rng(B * 1000 + H * 10 + W)
    xs = np.arange(W, dtype=np.float32)
    dl = np.float32(rng.integers(0, W + 3, (B, H, W))
                    + rng.choice([0.0, 0.25, 0.5, 0.75], (B, H, W)))
    dl[..., 0, :] = xs                       # every shift lands on column 0
    if H > 1:
        dl[..., 1, :] = xs + 1               # one past it
    dl[rng.uniform(size=dl.shape) < 0.15] = -1.0
    dr = np.float32(rng.integers(-1, W, (B, H, W))
                    + rng.choice([0.0, 0.5], (B, H, W)))
    dl, dr = (torch.tensor(a, device=cuda) for a in (dl, dr))
    for max_s in sorted({0, 1, W // 2, W - 2, W - 1, W}):
        for lrc in (1.5, 0.0):
            got = wc.shift_gather_conf(dl, dr, max_s, lrc)
            torch.cuda.synchronize()
            want = wplain.shift_gather_conf(dl, dr, max_s, lrc)
            assert torch.equal(got, want), (max_s, lrc)
    # max_s at its edge: shifts of exactly max_s gather, max_s + 1 do not
    s = 3
    edge = torch.full((B, H, W), float(s), device=cuda)
    for max_s in (s - 1, s):
        got = wc.shift_gather_conf(edge, edge, max_s)
        assert torch.equal(got, wplain.shift_gather_conf(edge, edge, max_s))
        assert bool((got[:, 1, :, s:] == float(max_s >= s)).all())


@pytest.mark.parametrize("H,W,kw", [
    (32, 48, dict(num_disparities=16)),
    (40, 72, dict(num_disparities=48, min_disparity=3)),
    (24, 40, dict(num_disparities=64, num_paths=4)),       # W < D
    (48, 300, dict(num_disparities=256, min_disparity=5, num_paths=2)),
    (36, 100, dict(num_disparities=32, block_size=3, uniqueness_ratio=0,
                   quantize_16=False, disp12_max_diff=-1)),
    (30, 90, dict(num_disparities=80, block_size=1, p1=8, p2=32)),
    (1, 50, dict(num_disparities=16)),                     # one row
    # cost_down's strips: widths no strip divides, blocks 1-11 (the larger
    # ones at a lower pre_filter_cap, or 4 paths, so three paths fit int16),
    # D 16 and 256, H 1 and 2, 1, 9 and 16 frames (16 in several launches)
    (29, 70, dict(num_disparities=16, block_size=1)),
    (33, 101, dict(num_disparities=32, block_size=3, min_disparity=3)),
    (40, 97, dict(num_disparities=48, block_size=7, pre_filter_cap=31,
                  p1=8, p2=96, frames=1)),
    (20, 90, dict(num_disparities=64, block_size=11, pre_filter_cap=15,
                  p1=4, p2=32, frames=9)),
    (24, 50, dict(num_disparities=16, block_size=11, pre_filter_cap=31,
                  num_paths=4, p1=8, p2=100)),
    (2, 61, dict(num_disparities=16)),                     # two rows
    (1, 77, dict(num_disparities=256, frames=1)),
    (12, 300, dict(num_disparities=256)),
    (6, 1280, dict(num_disparities=128, frames=16)),
])
def test_staged_kernels_match_plain(cuda, H, W, kw):
    """The fused cost + down kernel, K2 on an int16 S and the three-input
    WTA/LR against their plain versions and against K1-K3, bitwise."""
    kw = dict(kw)
    B = kw.pop("frames", 2)
    params = SGBMParams(speckle_window_size=0, **kw)
    D = params.num_disparities
    pairs = [pair(H, W, D, seed=H + i) for i in range((B + 1) // 2)]
    left, right = (np.concatenate([p[j] for p in pairs])[:B] for j in (0, 1))
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), cap)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), cap)
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
    assert torch.equal(got, sc.sgbm_cuda(left, right, params,
                                         fused_wta=False))
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


@pytest.mark.parametrize("H,W,kw", [
    (32, 48, dict(num_disparities=16)),
    (40, 72, dict(num_disparities=48, min_disparity=3, num_paths=4)),
    (150, 130, dict(num_disparities=128, block_size=3, p1=72, p2=288)),
    (36, 83, dict(num_disparities=64)),                     # ragged width
    (30, 70, dict(num_disparities=32, block_size=7)),       # int32 route
    (28, 61, dict(num_disparities=80, block_size=7, num_paths=4)),
    (12, 1500, dict(num_disparities=32)),   # strips past 10: WTA inline
])
@pytest.mark.parametrize("top,bottom", [(0, 0), (8, 8), (64, 0), (8, 64),
                                        (64, 64)])
def test_sgbm_tile_matches_plain(cuda, H, W, kw, top, bottom):
    """K9, the tile matcher, against ``plain.sgbm_tile`` bitwise, LR on and
    off, at the smoke's halos 0, 8 and 64: halos of zero rows (beyond the
    image's edges) around the image's rows, and halos cut from the image's
    own rows where it has enough. The route follows ``tile_bias``: a bias
    (16 disparities at block 5, 4 paths at block 7) or none (block 3, and
    4 paths at block 5) runs tile_sgm.cu's sweeps and no K2 or K3; 8 paths
    at block 7 run K2 x8 and K3 on an int32 S, and equal the int16 route's
    plain stages where both apply."""
    params = SGBMParams(speckle_window_size=0, **kw)
    bias = sc.tile_bias(params)
    left, right = pair(H, W, params.num_disparities, seed=H + top)
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(torch.tensor(left[:1], device=cuda), cap)
    rt = plain.sobel_clip(torch.tensor(right[:1], device=cuda), cap)
    C = sc.cost_volume(lt, rt, params)
    z = torch.zeros((1, 64, W, params.num_disparities), dtype=torch.int16,
                    device=cuda)
    slabs = [torch.cat([z[:, :top], C, z[:, :bottom]], dim=1)]
    if top + bottom < H:
        slabs.append(C)
    for slab in slabs:
        for apply_lr in (True, False):
            before = dict(sc.LAUNCHES)
            got = sc.sgbm_tile_cuda(slab, params, top, bottom, apply_lr)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in sc.LAUNCHES.items()
                   if v != before[k]}
            if bias is None:
                assert ran == {"sgm_pass": 8, "wta_lr": 1, "sgbm_tile": 1}
            else:
                assert ran == {"agg_down": 1, "agg_horiz": 1,
                               "agg_up_wta": 1, "sgbm_tile": 1,
                               **({"agg_lr": 1} if apply_lr else {})}
            want = plain.sgbm_tile(slab, params, top, bottom, apply_lr)
            assert got.shape == want.shape == (
                1, slab.shape[1] - top - bottom, W)
            assert torch.equal(got, want)
            assert torch.equal(
                sc._sgbm_tile_i32(slab, params, top, apply_lr)[
                    :, :got.shape[1]], got)
    if bias is not None:
        slab = slabs[0]
        S = sc.agg_down(slab, params, bias, top)
        assert torch.equal(S.float(), plain.tile_down_sum(slab, params, top,
                                                          bias))
        body = slab[:, top:]
        want = plain.tile_horizontal(body, S, params)
        sc.agg_horiz(body, S, params)
        assert torch.equal(S.float(), want)
        # the top halo over a batch: each frame's S_dh starts below it
        two = torch.cat([slab, slab.flip(2).contiguous()])
        assert torch.equal(sc.agg_down(two, params, bias, top).float(),
                           plain.tile_down_sum(two, params, top, bias))


def batch_pair(B, H, W, D, seed):
    """B random-texture frames whose right views are shifted by D // 3."""
    pairs = [pair(H, W, D, seed=seed + i) for i in range((B + 1) // 2)]
    return (np.concatenate([p[j] for p in pairs])[:B] for j in (0, 1))


def ran_since(before):
    return {k: v - before[k] for k, v in sc.LAUNCHES.items()
            if v != before[k]}


@pytest.mark.parametrize("B,H,W,kw", [
    (1, 40, 301, dict(num_disparities=16)),
    (2, 33, 157, dict(num_disparities=48, min_disparity=3)),
    (8, 24, 301, dict(num_disparities=128)),
    (2, 20, 523, dict(num_disparities=256)),
    (8, 12, 1100, dict(num_disparities=256, block_size=3)),   # waves
    (8, 17, 45, dict(num_disparities=16, num_paths=4, block_size=7)),
    (2, 26, 201, dict(num_disparities=64, block_size=3, quantize_16=False,
                      disp12_max_diff=0)),
    (1, 31, 271, dict(num_disparities=48, uniqueness_ratio=0,
                      disp12_max_diff=-1)),
    (1, 16, 1500, dict(num_disparities=32)),        # one frame, wide strips
    (4, 18, 403, dict(num_disparities=64, num_paths=4, block_size=7)),
    (2, 40, 1280, dict(num_disparities=128)),       # the live pair's frames
    (16, 14, 1280, dict(num_disparities=128)),      # a batch of 8 pairs
    (2, 33, 1001, dict(num_disparities=80)),        # lanes beyond D
    (16, 13, 700, dict(num_disparities=256)),
])
def test_batch_sweeps_match_plain(cuda, B, H, W, kw):
    """The matcher's batch route over B frames (csrc/tile_sgm.cu's sweeps
    at a frame a slab) against its plain stages frame by frame, bitwise,
    and against K2 x8 + K3 (``fused_wta=False``); widths that no strip
    width divides (a strip is ceil(W / SMs) columns), LR on and off, and
    the mirror mode with the trailing frames (or all of them) mirrored;
    at 8 frames of 1100 x 256 more frames than the card holds at once, so
    the frames go in waves. The cases cover each launch plan: one frame
    of narrow strips (WTA warps a row behind) and of wide ones (the WTA
    inline), 2 frames and more (the ring's WTA warps; path warps of one
    column and, from 4 frames, of two) at D 16 to 256 (D 80: lanes beyond
    D), the ring's slots reused many times over (H >= 13, 3 slots)."""
    params = SGBMParams(speckle_window_size=0, **kw)
    bias = sc.tile_bias(params)
    assert bias is not None and sc.agg_route(params) == "sweeps"
    D = params.num_disparities
    left, right = batch_pair(B, H, W, D, seed=W)
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(torch.tensor(left, device=cuda), cap)
    rt = plain.sobel_clip(torch.tensor(right, device=cuda), cap)
    C = sc.cost_volume(lt, rt, params)
    before = dict(sc.LAUNCHES)
    S = sc.agg_down(C, params, bias)
    torch.cuda.synchronize()
    assert ran_since(before) == {"agg_down": 1}
    want = plain.tile_down_sum(C, params, 0, bias)
    assert torch.equal(S.float(), want)
    want = plain.tile_horizontal(C, S, params)
    sc.agg_horiz(C, S, params)
    torch.cuda.synchronize()
    assert torch.equal(S.float(), want)
    S32 = sc.aggregate(C, params)
    for m in sorted({B, B // 2, 0}):
        for apply_lr in (True, False):
            before = dict(sc.LAUNCHES)
            got = sc.agg_up_wta(C, S, params, bias, apply_lr, mirror_from=m)
            torch.cuda.synchronize()
            lr = apply_lr and params.disp12_max_diff >= 0
            assert ran_since(before) == {
                "agg_up_wta" if m == B else "agg_up_wta_mirror": 1,
                **({"agg_lr": 1} if lr else {})}
            for b in range(B):
                assert torch.equal(got[b], plain.tile_up_wta(
                    C[b], S[b], params, bias, apply_lr, mirror_lr=b >= m))
            assert torch.equal(got, sc.wta_lr(S32, params, apply_lr,
                                              mirror_from=m))
            assert torch.equal(got, sc.aggregate_wta(C, params, apply_lr, m))


@pytest.mark.parametrize("B,W,D,plan", [
    (2, 1280, 128, "inline"),    # the live pair's two frames
    (16, 1280, 128, "inline"),   # a batch of 8 pairs, stacked
    (1, 1280, 128, "ring"),      # one frame of narrow strips
    (1, 2560, 256, "ring"),      # one frame of wide strips
    (2, 640, 80, "ring"),        # two frames of strips of 5 columns
])
def test_up_wta_plan_by_shape(cuda, B, W, D, plan):
    """The up sweep with the WTA takes its launch plan from the shape:
    ``UP_WTA_PLANS`` counts the plan the launch reports, and
    ``sweep_plan`` gives it beforehand; the ring puts the frames in no
    more waves than the inline plan would."""
    params = SGBMParams(num_disparities=D, speckle_window_size=0)
    bias = sc.tile_bias(params)
    C = torch.zeros((B, 8, W, D), dtype=torch.int16, device=cuda)
    S = sc.agg_down(C, params, bias)
    chosen = sc.sweep_plan(True, B, W, D)
    assert chosen["plan"] == plan
    before = dict(sc.UP_WTA_PLANS)
    sc.agg_up_wta(C, S, params, bias)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in sc.UP_WTA_PLANS.items()
            if v != before[k]} == {plan: 1}
    inline = sc.sweep_plan(True, B, W, D, "inline")
    assert 0 < chosen["waves"] <= inline["waves"]
    assert sc.sweep_plan(False, B, W, D)["plan"] == "down"


@pytest.mark.parametrize("kw,route", [
    (dict(), "sweeps"),
    (dict(num_paths=4), "sweeps"),
    (dict(block_size=3), "sweeps"),
    (dict(block_size=7), "passes"),                  # bias None
    (dict(num_paths=2), "passes"),
    (dict(fused_wta=False), "passes"),
])
def test_sgbm_cuda_takes_the_route_it_picks(cuda, kw, route):
    """sgbm_cuda and sgbm_pair_cuda launch the batch sweeps and no K2 or
    K3 on the sweeps' route, K2 per direction and K3 on the other, and
    give the same bits either way (and the plain matcher's)."""
    kw = dict(kw)
    fused = kw.pop("fused_wta", True)
    params = SGBMParams(num_disparities=48, speckle_window_size=20,
                        speckle_range=2, **kw)
    assert sc.agg_route(params, fused) == route
    left, right = (torch.tensor(a, device=cuda)
                   for a in batch_pair(4, 40, 150, 48, seed=7))
    before = dict(sc.LAUNCHES)
    got = sc.sgbm_cuda(left, right, params, fused_wta=fused)
    torch.cuda.synchronize()
    n = len(params.path_dirs)
    matcher = ({"agg_down": 1, "agg_horiz": 1, "agg_up_wta": 1, "agg_lr": 1}
               if route == "sweeps" else {"sgm_pass": n, "wta_lr": 1})
    assert ran_since(before) == {"cost_box": 1, "speckle_labels": 1,
                                 "speckle_keep": 1, **matcher}
    other = sc.sgbm_cuda(left, right, params, fused_wta=route != "sweeps")
    assert torch.equal(got, other)
    assert torch.equal(got, plain.sgbm(left, right, params))
    if params.num_paths < 4:
        return
    before = dict(sc.LAUNCHES)
    dl, dr = sc.sgbm_pair_cuda(left, right, params, fused_wta=fused)
    torch.cuda.synchronize()
    matcher = ({"agg_down": 1, "agg_horiz": 1, "agg_up_wta_mirror": 1,
                "agg_lr": 1} if route == "sweeps"
               else {"sgm_pass": n, "wta_lr_mirror": 1})
    assert ran_since(before) == {"cost_box_pair": 1, "speckle_labels": 1,
                                 "speckle_keep": 1, **matcher}
    ol, orr = sc.sgbm_pair_cuda(left, right, params,
                                fused_wta=route != "sweeps")
    assert torch.equal(dl, ol) and torch.equal(dr, orr)
    dd = sc.sgbm_cuda(torch.cat([left, right.flip(-1)]),
                      torch.cat([right, left.flip(-1)]), params,
                      fused_wta=False)
    assert torch.equal(dl, dd[:4]) and torch.equal(dr, dd[4:].flip(-1))


@pytest.mark.parametrize("extra,route", [(0, "sweeps"), (1, "passes")])
def test_route_at_the_widest_frame_the_sweeps_take(cuda, extra, route):
    """A frame of ``sweep_max_width`` columns (a strip of SWEEP_MAX_STRIP
    columns a multiprocessor) takes the batch sweeps; one column more takes
    K2 per direction + K3, chosen before any launch (K3 past 4096 columns
    on the opt-in shared memory); sgbm_cuda and sgbm_pair_cuda equal the
    plain matcher either way."""
    params = SGBMParams(num_disparities=16, speckle_window_size=20,
                        speckle_range=2)
    W = sc.sweep_max_width(cuda) + extra
    assert sc.agg_route(params, True, W, sc.sweep_max_width(cuda)) == route
    left, right = (torch.tensor(a, device=cuda)
                   for a in batch_pair(1, 12, W, 16, seed=5))
    before = dict(sc.LAUNCHES)
    got = sc.sgbm_cuda(left, right, params)
    torch.cuda.synchronize()
    matcher = ({"agg_down": 1, "agg_horiz": 1, "agg_up_wta": 1, "agg_lr": 1}
               if route == "sweeps" else {"sgm_pass": 8, "wta_lr": 1})
    assert ran_since(before) == {"cost_box": 1, "speckle_labels": 1,
                                 "speckle_keep": 1, **matcher}
    # the right matcher: mirrored, swapped frames, flipped back
    stack_l = torch.cat([left, right.flip(-1)])
    stack_r = torch.cat([right, left.flip(-1)])
    want = plain.sgbm(stack_l, stack_r, params)
    assert torch.equal(got, want[:1])
    before = dict(sc.LAUNCHES)
    dl, dr = sc.sgbm_pair_cuda(left, right, params)
    torch.cuda.synchronize()
    matcher = ({"agg_down": 1, "agg_horiz": 1, "agg_up_wta_mirror": 1,
                "agg_lr": 1} if route == "sweeps"
               else {"sgm_pass": 8, "wta_lr_mirror": 1})
    assert ran_since(before) == {"cost_box_pair": 1, "speckle_labels": 1,
                                 "speckle_keep": 1, **matcher}
    assert torch.equal(dl, want[:1]) and torch.equal(dr, want[1:].flip(-1))


@pytest.mark.parametrize("block", [5, 7])
def test_sharded_world_of_one_matches_sgbm_cuda(cuda, tmp_path, block):
    """A world of one NCCL rank on the mesh (1, 1, 1): sgbm_sharded takes
    the tile route (K1, K9, K4/K5) and equals sgbm_cuda bitwise; two tiles
    with a full-coverage halo, run one after the other in this process,
    equal it too. At block 5 K9 runs tile_sgm.cu's sweeps and no K2 or
    K3; at block 7 (S_dh past the biased int16 range) K2 x8 and K3."""
    import torch.distributed as dist
    from stereo_depth_ruler_tpu_torch.parallel import make_mesh, sgbm_sharded
    from stereo_depth_ruler_tpu_torch.parallel.sharded import _sgbm_cuda_tile
    params = SGBMParams(num_disparities=48, speckle_window_size=20,
                        speckle_range=2, block_size=block)
    left, right = (torch.tensor(a[0], device=cuda)
                   for a in pair(64, 160, 48, seed=3))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, 1)
        sc.reset_launch_counts()
        got = sgbm_sharded(left, right, params, mesh)
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
    finally:
        dist.destroy_process_group()
    want = sc.sgbm_cuda(left[None], right[None], params, fused_wta=False)[0]
    assert torch.equal(got, want)
    tile = ({"sgm_pass", "wta_lr"} if block == 7 else
            {"agg_down", "agg_horiz", "agg_up_wta", "agg_lr"})
    assert {k for k, v in launches.items() if v} == {
        "cost_box", "sgbm_tile", "speckle_labels", "speckle_keep", *tile}
    if block == 7:
        assert launches["sgm_pass"] == 8 and launches["sgbm_tile"] == 1
    else:
        assert all(launches[k] == 1 for k in tile)
        assert launches["sgbm_tile"] == 1
    tiles = torch.cat([_sgbm_cuda_tile(left, right, params, k, 2, 32, 32)
                       for k in range(2)])
    assert torch.equal(tiles, sc.sgbm_cuda(left[None], right[None], params,
                                           apply_speckle=False,
                                           fused_wta=False)[0])


def test_dryrun_multichip_on_the_cards(cuda):
    """dryrun_multichip's default world: NCCL, one rank a card. Four ranks
    on the mesh (1, 2, 2) where the machine has four cards (the D split's
    plain scans, the halo exchange and K6/K7 on the cards, then the tile
    route), else a world of one on (1, 1, 1)."""
    from stereo_depth_ruler_tpu_torch.parallel.dryrun import dryrun_multichip
    n = 4 if torch.cuda.device_count() >= 4 else 1
    msg = dryrun_multichip(n, tile_rows=32, width=128, num_disp=32,
                           frames_per_group=2, timeout=300.0)
    want = "(frame=1, tile=2, disp=2)" if n == 4 else \
        "(frame=1, tile=1, disp=1)"
    assert msg.startswith(f"dryrun_multichip ok: mesh{want} on cuda"), msg


def test_voxels_on_the_card_key_as_the_cpu(cuda):
    """voxel_downsample on a CUDA tensor keys points on a voxel edge by the
    float32 product floor(x * (1 / leaf)), as the CPU does, and counts and
    orders voxels as the CPU does."""
    from stereo_depth_ruler_tpu_torch.ops.voxel import voxel_downsample
    x = np.array([776.99994, 857.99994, 989.99994, -121.8, -809.9],
                 np.float32)
    edge = np.floor(x / np.float32(3)) != np.floor(
        x * (np.float32(1) / np.float32(3)))
    assert edge.any()
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1000, 1000, (20000, 3)).astype(np.float32)
    xyz[:5, 0] = x
    xyz[7::97] = np.nan
    rgb = rng.uniform(0, 255, xyz.shape).astype(np.float32)
    for leaf in (3.0, 0.7, 5.0, 25.0):
        got = voxel_downsample(torch.tensor(xyz, device=cuda),
                               torch.tensor(rgb, device=cuda), leaf)
        want = voxel_downsample(torch.tensor(xyz), torch.tensor(rgb), leaf)
        n = int(got[2])
        assert n == int(want[2])
        if leaf == 3.0:
            # each edge point is a voxel of its own, keyed by the product
            keys = np.floor(got[0][:n, 0].cpu().numpy()
                            * (np.float32(1) / np.float32(leaf)))
            for k in np.floor(x[edge] * (np.float32(1) / np.float32(leaf))):
                assert k in keys
        np.testing.assert_allclose(got[0][:n].cpu().numpy(),
                                   want[0][:n].numpy(), atol=1e-3)
        np.testing.assert_allclose(got[1][:n].cpu().numpy(),
                                   want[1][:n].numpy(), atol=1e-2)


def test_cloud_on_the_card_matches_the_cpu(cuda):
    """PointCloudGenerator on the card (K1-K5) against its plain versions
    on the CPU: the disparity bitwise, the voxel count exact."""
    from stereo_depth_ruler_tpu_torch.cloud import (CloudConfig,
                                                    PointCloudGenerator)
    rig = StereoRig.synthetic(width=160, height=96, focal=90.0,
                              baseline_mm=60.0)
    scene = make_scene(rig, n_boxes=3, z_range_mm=(300.0, 800.0),
                       background_z_mm=1500.0, seed=2)
    left, right, _ = render_stereo_pair(scene, seed=2)
    cfg = CloudConfig(sgbm=SGBMParams(num_disparities=32,
                                      speckle_window_size=50), leaf=5.0)
    sc.reset_launch_counts()
    got = PointCloudGenerator(rig, cfg, device=cuda).cloud_from_pair(left,
                                                                    right)
    assert sc.LAUNCHES["cost_box"] == 1 and sc.LAUNCHES["speckle_keep"] == 1
    want = PointCloudGenerator(rig, cfg, device="cpu").cloud_from_pair(left,
                                                                       right)
    np.testing.assert_array_equal(got["disparity"], want["disparity"])
    assert got["count"] == want["count"] > 100
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-3)


def test_bench_and_entry_match_plain_on_the_card(cuda, monkeypatch):
    """The bench's flagship (2 frames of 160x96, 32 disparities, LR,
    speckle 200/2, depth) and entry()'s forward on the card, disparity and
    depth or xyz bitwise equal to the plain matcher + reproject_to_3d on
    the same tensors."""
    from stereo_depth_ruler_tpu_torch import bench, entry
    from stereo_depth_ruler_tpu_torch.ops.reproject import reproject_to_3d
    H, W, D = 96, 160, 32
    monkeypatch.setattr(bench, "H", H)
    monkeypatch.setattr(bench, "W", W)
    monkeypatch.setattr(bench, "D", D)
    rig, lefts, rights = bench.make_inputs(batch=2)
    sc.reset_launch_counts()
    run = bench.bench_flagship(rig, lefts, rights, iters=1, device="cuda")
    torch.cuda.synchronize()
    assert run.fps > 0 and sc.LAUNCHES["speckle_keep"] == run.calls
    disp, z = run.first
    params = entry.flagship_params(D)
    ref = plain.sgbm(torch.tensor(np.float32(lefts), device=cuda),
                     torch.tensor(np.float32(rights), device=cuda), params)
    assert torch.equal(disp, ref)
    assert torch.equal(z, reproject_to_3d(ref, rig.Q)[..., 2])
    fwd, rig, params = entry._flagship(H, W, D, device="cuda")
    left, right = entry._example_pair(H, W, cuda)
    d, xyz = fwd(left, right)
    ref = plain.sgbm(left[None], right[None], params)[0]
    assert torch.equal(d, ref)
    assert torch.equal(xyz, reproject_to_3d(ref, rig.Q))
