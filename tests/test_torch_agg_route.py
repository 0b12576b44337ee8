"""The matcher's aggregation route (ops/sgbm_cuda.py: agg_route,
aggregate_wta and the CPU path of agg_down, agg_horiz and agg_up_wta,
csrc/tile_sgm.cu's batch sweeps) against the JAX main path in interpret
mode: ``_fused_aggregate_wta`` (the biased int16 route, and the
three-volume one where ``_wta_bias`` gives None), ``_fused_aggregate_wta_pair``
with the right matcher's mirrored LR, ``sgbm_pallas`` (``fused_wta`` on and
off) and ``sgbm_pair_pallas``; and the route ``agg_route`` picks against
the branch ``sgbm_pallas`` takes, and at the widest frame the sweeps take.

Batches of two random-texture frames at 24x40 and 32x56, 16 and 32
disparities, 4 and 8 paths, blocks 3, 5 and 7. Every value is an exact
small integer or a disparity both sides compute with the same float
operations, so every comparison is bitwise (tolerance 0). The Pallas
volumes are (H, D, W) a frame, permuted to the port's (H, W, D); the JAX
functions take one frame, so they run frame by frame, jitted once per case
(cached) in interpret mode."""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_depth_ruler_tpu.ops import sgbm_pallas as sp
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc

B = 2
# name -> (paths, block, D, H, W); the route at the default P2: a bias at
# 8 paths block 5 and 4 paths block 7, bias 0 at block 3 and at 4 paths
# block 5, None (the three-volume / int32 route) at 8 paths block 7
CASES = {"8p-b5-d16": (8, 5, 16, 24, 40), "4p-b5-d32": (4, 5, 32, 32, 56),
         "8p-b3-d32": (8, 3, 32, 24, 40), "4p-b7-d16": (4, 7, 16, 32, 56),
         "8p-b7-d16": (8, 7, 16, 24, 40)}


def params_of(case, **kw):
    paths, block, D, _, _ = CASES[case]
    return SGBMParams(num_disparities=D, block_size=block, num_paths=paths,
                      speckle_window_size=0, **kw)


def jp(params):
    return JaxParams(**dataclasses.asdict(params))


@functools.lru_cache(maxsize=None)
def frames(case):
    """(left, right) float32 (B, H, W) random-texture pairs, the right view
    the left one shifted by 5 px with noise."""
    _, _, _, H, W = CASES[case]
    rng = np.random.default_rng(H + W)
    left = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -5, axis=2)
                    + rng.normal(0, 3, left.shape), 0, 255)
    return left, right.astype(np.float32)


def volumes(case):
    """The port's (B, H, W, D) int16 cost volume and the pair's (2B, H, W,
    D) one (left matcher's frames, then the right matcher's)."""
    params = params_of(case)
    cap = params.pre_filter_cap
    lt, rt = (ts.sobel_clip(torch.tensor(a), cap) for a in frames(case))
    return (sc.cost_volume(lt, rt, params),
            sc.cost_volume_pair(lt, rt, params))


def hdw(C):
    """A port (H, W, D) frame as a Pallas (H, D, W) volume."""
    return jnp.asarray(np.transpose(C.numpy(), (0, 2, 1)))


@functools.lru_cache(maxsize=None)
def jax_fused(case):
    """``_fused_aggregate_wta`` of each frame, LR on and off, plain and
    mirrored; ``_fused_aggregate_wta_pair`` of each frame's pair volumes;
    one jitted function a case."""
    params = params_of(case)
    j = jp(params)
    C, Cp = volumes(case)

    def pieces(c, cl, cr):
        out = {f"{lr} {mirror}": sp._fused_aggregate_wta(
            c, j, lr, jnp.int16, mirror_lr=mirror)
            for lr in (True, False) for mirror in (False, True)}
        out["pair"] = sp._fused_aggregate_wta_pair(cl, cr, j, True, jnp.int16)
        return out

    with pltpu.force_tpu_interpret_mode():
        f = jax.jit(pieces)
        per = [jax.tree_util.tree_map(np.asarray,
                                      f(hdw(C[b]), hdw(Cp[b]),
                                        hdw(Cp[B + b])))
               for b in range(B)]
    return {k: [p[k] for p in per] for k in per[0]}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_route_matches_fused_aggregate_wta(case):
    """The batch route's plain stages (the wrappers on CPU tensors), or K2
    + K3's plain versions where the bias is None, equal
    ``_fused_aggregate_wta`` frame by frame, LR on and off, the mirrored
    LR included (all frames mirrored, and only the second)."""
    params = params_of(case)
    C, _ = volumes(case)
    want = jax_fused(case)
    bias = sc.tile_bias(params)
    if bias is not None:
        S_dh = sc.agg_down(C, params, bias)
        assert S_dh.dtype == torch.int16
        assert torch.equal(S_dh.float(), ts.tile_down_sum(C, params, 0, bias))
        sc.agg_horiz(C, S_dh, params)
    for lr in (True, False):
        for m in (B, 1, 0):
            got = (sc.agg_up_wta(C, S_dh, params, bias, lr, m)
                   if bias is not None else
                   sc.aggregate_wta(C, params, lr, m))
            assert torch.equal(got, sc.aggregate_wta(C, params, lr, m,
                                                     fused_wta=False))
            for b in range(B):
                np.testing.assert_array_equal(got[b].numpy(),
                                              want[f"{lr} {b >= m}"][b])


@pytest.mark.parametrize("case", list(CASES))
def test_pair_route_matches_fused_aggregate_wta_pair(case):
    """``aggregate_wta`` on the pair volume (2B frames, the right half
    mirrored) equals ``_fused_aggregate_wta_pair`` frame by frame."""
    params = params_of(case)
    _, Cp = volumes(case)
    got = sc.aggregate_wta(Cp, params, mirror_from=B)
    for b in range(B):
        dl, dr = jax_fused(case)["pair"][b]
        np.testing.assert_array_equal(got[b].numpy(), dl)
        np.testing.assert_array_equal(got[B + b].numpy(), dr)


@functools.lru_cache(maxsize=None)
def jax_matcher(case, speckle):
    """``sgbm_pallas`` of each frame, ``fused_wta`` on and off, and
    ``sgbm_pair_pallas``; one jitted function a case."""
    params = params_of(case)
    j = jp(dataclasses.replace(params, speckle_window_size=speckle,
                               speckle_range=2))
    left, right = frames(case)

    def matchers(l, r):
        return {"True": sp.sgbm_pallas(l, r, j, fused_wta=True),
                "False": sp.sgbm_pallas(l, r, j, fused_wta=False),
                "pair": sp.sgbm_pair_pallas(l, r, j)}

    with pltpu.force_tpu_interpret_mode():
        f = jax.jit(matchers)
        per = [jax.tree_util.tree_map(np.asarray,
                                      f(jnp.asarray(left[b]),
                                        jnp.asarray(right[b])))
               for b in range(B)]
    return {k: [p[k] for p in per] for k in per[0]}


@pytest.mark.parametrize("case,speckle", [
    ("8p-b5-d16", 0), ("8p-b5-d16", 20), ("4p-b7-d16", 0), ("8p-b7-d16", 0)])
def test_sgbm_cuda_matches_sgbm_pallas(case, speckle):
    """``sgbm_cuda`` (``fused_wta`` on and off) and ``sgbm_pair_cuda`` on
    CPU tensors equal ``sgbm_pallas`` and ``sgbm_pair_pallas`` frame by
    frame, speckle filter off and on."""
    params = dataclasses.replace(params_of(case), speckle_window_size=speckle,
                                 speckle_range=2)
    left, right = (torch.tensor(a) for a in frames(case))
    want = jax_matcher(case, speckle)
    for fused in (True, False):
        got = sc.sgbm_cuda(left, right, params, fused_wta=fused)
        for b in range(B):
            np.testing.assert_array_equal(got[b].numpy(),
                                          want[str(fused)][b])
    dl, dr = sc.sgbm_pair_cuda(left, right, params)
    for b in range(B):
        np.testing.assert_array_equal(dl[b].numpy(), want["pair"][b][0])
        np.testing.assert_array_equal(dr[b].numpy(), want["pair"][b][1])


class _Branch(Exception):
    pass


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("paths", [2, 4, 8])
@pytest.mark.parametrize("block", [3, 5, 7])
def test_route_is_sgbm_pallas_branch(monkeypatch, block, paths, fused):
    """``agg_route`` picks "sweeps" exactly where ``sgbm_pallas`` takes
    ``_fused_aggregate_wta``'s biased branch (``up_wta_pallas`` with no
    S_h) and "passes" where it takes the three-volume branch or the
    unfused one. The JAX call stops at its branch (no Pallas runs past
    the cost volume)."""
    params = SGBMParams(num_disparities=16, block_size=block,
                        num_paths=paths, speckle_window_size=0)

    def up_wta(C, S_dh, S_h, *a, **k):
        raise _Branch("biased" if S_h is None else "three volumes")

    def unfused(*a, **k):
        raise _Branch("unfused")

    monkeypatch.setattr(sp, "up_wta_pallas", up_wta)
    monkeypatch.setattr(sp, "aggregate_paths_pallas_hdw", unfused)
    # the volumes before the branch: zeros of their shapes
    monkeypatch.setattr(sp, "build_cost_volume_pallas", lambda lt, rt, p, **k:
                        jnp.zeros((lt.shape[0], p.num_disparities,
                                   lt.shape[1]), jnp.int16))
    monkeypatch.setattr(sp, "directional_pass_pallas",
                        lambda C, *a, **k: jnp.zeros_like(C))
    left, right = (jnp.asarray(a[0]) for a in frames("8p-b5-d16"))
    with pltpu.force_tpu_interpret_mode(), pytest.raises(_Branch) as branch:
        sp.sgbm_pallas(left, right, jp(params), fused_wta=fused)
    want = "sweeps" if str(branch.value) == "biased" else "passes"
    assert sc.agg_route(params, fused) == want
    assert sc.sweeps_take(16) and not sc.sweeps_take(40)
    assert sc.agg_route(dataclasses.replace(params, num_disparities=40),
                        fused) == "passes"


@pytest.mark.parametrize("sms,width,route", [
    (132, 4224, "sweeps"), (132, 4225, "passes"),
    (114, 3648, "sweeps"), (114, 3649, "passes"),
])
def test_route_stops_at_the_widest_frame(sms, width, route):
    """The sweeps take a frame of at most ``SWEEP_MAX_STRIP`` columns a
    multiprocessor (csrc/tile_sgm.cu's SWMAX, read from the source): on a
    card of ``sms`` multiprocessors ``agg_route`` sends a wider frame to
    K2 + K3 from its width alone; on the CPU (``sweep_max_width`` None)
    the plain stages take any width."""
    src = (Path(sc.__file__).parent / "csrc" / "tile_sgm.cu").read_text()
    swmax = re.search(r"constexpr int SWMAX = (\d+);", src).group(1)
    assert int(swmax) == sc.SWEEP_MAX_STRIP
    params = SGBMParams()
    assert sc.agg_route(params, True, width,
                        sc.SWEEP_MAX_STRIP * sms) == route
    assert sc.agg_route(params, False, width,
                        sc.SWEEP_MAX_STRIP * sms) == "passes"
    assert sc.sweep_max_width(torch.device("cpu")) is None
    assert sc.agg_route(params, True, width, None) == "sweeps"


def test_up_wta_plans_start_empty_and_reset():
    """``UP_WTA_PLANS`` names csrc/tile_sgm.cu's up-sweep plans by the
    numbers the source gives them (read from it), starts at zero, counts
    no launch of a CPU call (the plain stages) and resets to zero."""
    src = (Path(sc.__file__).parent / "csrc" / "tile_sgm.cu").read_text()
    numbers = {name.lower(): int(v) for name, v in re.findall(
        r"PLAN_(INLINE|RING) = (\d+)", src)}
    assert {sc._PLAN_NAMES[v]: v for v in numbers.values()} == numbers
    assert set(sc.UP_WTA_PLANS) == set(numbers)
    assert all(v == 0 for v in sc.UP_WTA_PLANS.values())
    params = params_of("8p-b5-d16")
    C = torch.randint(0, 60, (B, 24, 40, 16), dtype=torch.int16)
    bias = sc.tile_bias(params)
    sc.agg_up_wta(C, sc.agg_down(C, params, bias), params, bias)
    assert all(v == 0 for v in sc.UP_WTA_PLANS.values())
    sc.UP_WTA_PLANS["ring"] = 3
    sc.reset_up_wta_plans()
    assert all(v == 0 for v in sc.UP_WTA_PLANS.values())
