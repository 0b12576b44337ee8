"""The tile matcher's biased route (ops/sgbm.py: tile_down_sum,
tile_horizontal, tile_up_wta, sgbm_tile_biased; ops/sgbm_cuda.py:
tile_bias and the CPU path of the sweeps' wrappers agg_down, agg_horiz
and agg_up_wta, which K9 calls on a slab of one frame) against the JAX
package's own pieces of ``sgbm_tile_pallas`` in interpret mode:
``_wta_bias``, ``directional_pass_pallas(..., acc=..., out_offset=-bias)``
and ``up_wta_pallas(C_body, S_dh, None, params, sd_offset=bias)``.

Every value is an exact small integer or a disparity the two sides compute
with the same float operations, so every comparison is bitwise (tolerance
0). The Pallas volumes are (M, D, W) and are permuted to the port's
(M, W, D). The JAX pieces of a case run once (cached) and in interpret
mode, jitted."""

import dataclasses
import functools

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

LOCAL, W, D = 24, 40, 16
# (paths, block) -> the route at the default P2: 8 paths at block 5 and 4
# paths at block 7 shift S_dh by a bias, 8 paths at block 3 store it as
# it is
CASES = {"8p-b5": (8, 5), "4p-b7": (4, 7), "8p-b3": (8, 3)}


def params_of(paths, block):
    return SGBMParams(num_disparities=D, block_size=block, num_paths=paths,
                      speckle_window_size=0)


def jp(params):
    return JaxParams(**dataclasses.asdict(params))


def mwd(a):
    """A Pallas (M, D, W) volume in the port's (M, W, D) layout."""
    return torch.tensor(np.transpose(np.asarray(a), (0, 2, 1)))


def slab(params, top, bottom, seed):
    """(M, W, D) int16 cost slab of a random-texture pair, zero rows in the
    halos (the sharded path's rows beyond the image)."""
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (LOCAL, W)).astype(np.float32)
    right = np.clip(np.roll(left, -5, axis=1)
                    + rng.normal(0, 3, (LOCAL, W)), 0, 255).astype(np.float32)
    cap = params.pre_filter_cap
    C = ts.cost_volume(ts.sobel_clip(torch.tensor(left), cap),
                       ts.sobel_clip(torch.tensor(right), cap), params)
    z = torch.zeros((1, W, D))
    return torch.cat([z.expand(top, -1, -1), C,
                      z.expand(bottom, -1, -1)]).to(torch.int16)


@functools.lru_cache(maxsize=None)
def jax_pieces(case, top, bottom):
    """What ``sgbm_tile_pallas`` computes for the case's slab, piece by
    piece, in interpret mode: the biased down pass alone (acc 0), S_dh (the
    down pass accumulating the horizontal sum), the fused up + WTA on it
    (LR on and off), and ``sgbm_tile_pallas`` itself (LR on and off)."""
    params = params_of(*CASES[case])
    j = jp(params)
    with_diag = params.num_paths == 8
    bias = sp._wta_bias(j, with_diag, jnp.int16)
    C = jnp.asarray(np.transpose(slab(params, top, bottom, 1).numpy(),
                                 (0, 2, 1)))
    P1, P2 = j.P1, j.P2

    def pieces(C):
        out = {"down": sp.directional_pass_pallas(
            C, P1, P2, False, with_diag, acc=jnp.zeros_like(C),
            out_offset=-bias)}
        Ct = jnp.transpose(C[top:], (2, 1, 0))
        hf = sp.directional_pass_pallas(Ct, P1, P2, False, False)
        S_h = jnp.transpose(sp.directional_pass_pallas(Ct, P1, P2, True,
                                                       False, acc=hf),
                            (2, 1, 0))
        acc = jnp.concatenate([jnp.zeros((top,) + S_h.shape[1:], S_h.dtype),
                               S_h])
        S_dh = sp.directional_pass_pallas(C, P1, P2, False, with_diag,
                                          acc=acc, out_offset=-bias)
        out["S_dh"] = S_dh
        for lr in (True, False):
            out[f"up_wta_{lr}"] = sp.up_wta_pallas(
                C[top:], S_dh[top:], None, j, apply_lr=lr,
                with_diag=with_diag, sd_offset=bias)
            out[f"tile_{lr}"] = sp.sgbm_tile_pallas(C, j, top, bottom,
                                                    apply_lr=lr)
        return out

    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(pieces)(C)
    return bias, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("block", [3, 5, 7])
def test_tile_bias_matches_wta_bias(block, paths):
    """The chooser: bias 0, a shift of max_sum // 2, or None (the int32
    route) exactly where the JAX package's ``_wta_bias`` says so."""
    params = params_of(paths, block)
    want = sp._wta_bias(jp(params), paths == 8, jnp.int16)
    got = sc.tile_bias(params)
    assert (got is None) == (want is None)
    if got is not None:
        assert isinstance(got, int) and got == want
    expect = {(8, 3): 0, (8, 5): 21750, (8, 7): None, (4, 3): 0, (4, 5): 0,
              (4, 7): 25578}
    assert got == expect[paths, block]


HALOS = [(0, 0), (8, 8)]
ROUTES = [(c, h) for c in ("8p-b5", "4p-b7") for h in HALOS] + [
    ("8p-b3", (8, 8))]


@pytest.mark.parametrize(
    "case,halos,frames",
    [pytest.param(c, h, 1, id=f"{c}-halos{i}")
     for i, (c, h) in enumerate(ROUTES)]
    + [pytest.param("8p-b5", (8, 8), 2, id="8p-b5-halos1-2frames")])
def test_down_stage_matches_pallas(case, halos, frames):
    """The biased down sum, the plain version and the wrapper's CPU path
    (int16), equal to ``directional_pass_pallas(..., acc=0,
    out_offset=-bias)`` on the rows below the top halo. With two frames the
    wrapper takes the slab and its mirror image (columns reversed) at once;
    the down-going paths map onto each other under the mirror, so the
    second frame's sum is the first one's, mirrored."""
    top, bottom = halos
    bias, ref = jax_pieces(case, top, bottom)
    params = params_of(*CASES[case])
    C = slab(params, top, bottom, 1)
    assert sc.tile_bias(params) == bias
    want = mwd(ref["down"])[top:]
    got = ts.tile_down_sum(C, params, top, bias)
    assert torch.equal(got, want.to(torch.float32))
    batch = torch.stack([C, C.flip(1)][:frames])
    got16 = sc.agg_down(batch, params, sc.tile_bias(params), top)
    assert got16.dtype == torch.int16 and got16.shape[0] == frames
    assert torch.equal(got16[0], want)
    if frames == 2:
        assert torch.equal(got16[1], want.flip(1))


@pytest.mark.parametrize("case,halos", ROUTES)
def test_horizontal_stage_matches_pallas(case, halos):
    """The down sum plus both horizontal paths: S_dh as the JAX tile
    matcher stores it (its down pass accumulating the horizontal sum)."""
    top, bottom = halos
    bias, ref = jax_pieces(case, top, bottom)
    params = params_of(*CASES[case])
    C = slab(params, top, bottom, 1)
    want = mwd(ref["S_dh"])[top:]
    S = ts.tile_horizontal(C[top:], ts.tile_down_sum(C, params, top, bias),
                           params)
    assert torch.equal(S, want.to(torch.float32))
    S16 = sc.agg_down(C[None], params, int(bias), top)
    sc.agg_horiz(C[None, top:], S16, params)
    assert torch.equal(S16[0], want)


@pytest.mark.parametrize("apply_lr", [True, False])
@pytest.mark.parametrize("case,halos", ROUTES)
def test_up_wta_stage_matches_pallas(case, halos, apply_lr):
    """The up-going paths fused with the WTA on S_dh + bias, against
    ``up_wta_pallas(C_body, S_dh, None, params, sd_offset=bias)`` on the
    JAX package's own S_dh; the wrapper's CPU path keeps the local rows."""
    top, bottom = halos
    bias, ref = jax_pieces(case, top, bottom)
    params = params_of(*CASES[case])
    C = slab(params, top, bottom, 1)
    S_dh = mwd(ref["S_dh"])[top:]
    want = torch.tensor(ref[f"up_wta_{apply_lr}"])
    got = ts.tile_up_wta(C[top:], S_dh, params, bias, apply_lr)
    assert torch.equal(got, want)
    got = sc.agg_up_wta(C[None, top:], S_dh[None], params, int(bias),
                        apply_lr, local=LOCAL)
    assert torch.equal(got[0], want[:LOCAL])


@pytest.mark.parametrize("apply_lr", [True, False])
@pytest.mark.parametrize("case,halos", ROUTES)
def test_biased_route_matches_sgbm_tile_pallas(case, halos, apply_lr):
    """The assembled route, plain and through the stage wrappers' CPU
    paths, equal to ``sgbm_tile_pallas`` and to ``plain.sgbm_tile`` (the
    contract the card holds the kernels to)."""
    top, bottom = halos
    bias, ref = jax_pieces(case, top, bottom)
    params = params_of(*CASES[case])
    C = slab(params, top, bottom, 1)
    want = torch.tensor(ref[f"tile_{apply_lr}"])
    assert want.shape == (LOCAL, W)
    got = ts.sgbm_tile_biased(C, params, bias, top, bottom, apply_lr)
    assert torch.equal(got, want)
    assert torch.equal(ts.sgbm_tile(C, params, top, bottom, apply_lr), want)
    S = sc.agg_down(C[None], params, int(bias), top)
    sc.agg_horiz(C[None, top:], S, params)
    got = sc.agg_up_wta(C[None, top:], S, params, int(bias), apply_lr,
                        local=LOCAL)
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("paths", [4, 8])
def test_s_dh_at_the_int16_edge(paths):
    """Largest costs and the P2 path everywhere: every cell costs the
    largest box cost (block^2 * 4 * cap) but one random disparity, which
    costs 0, so almost every L is C + P2 = cmax + P2, the bound. S_dh
    reaches max_sum and its biased int16 store neither clamps nor wraps:
    the int16 stages plus the bias equal the float sums, and the route
    equals ``sgbm_tile``."""
    block = 5 if paths == 8 else 7
    params = params_of(paths, block)
    bias = sc.tile_bias(params)
    assert bias
    n_dirs = len(ts.down_dirs(paths)) + 2
    max_sum = sc.path_sum_bound(params, n_dirs)
    cmax = block ** 2 * 4 * params.pre_filter_cap
    top, bottom = 8, 8
    M = top + LOCAL + bottom
    rng = np.random.default_rng(paths)
    C = np.full((M, W, D), cmax, np.int16)
    C[np.arange(M)[:, None], np.arange(W)[None], rng.integers(0, D, (M, W))] = 0
    C = torch.tensor(C)
    S16 = sc.agg_down(C[None], params, bias, top)
    want = ts.tile_down_sum(C, params, top, 0.0)
    assert torch.equal(S16[0].to(torch.float32) + bias, want)
    sc.agg_horiz(C[None, top:], S16, params)
    want = ts.tile_horizontal(C[top:], want, params)
    assert torch.equal(S16[0].to(torch.float32) + bias, want)
    assert float(want.max()) == max_sum and float(want.min()) >= 0
    assert int(S16.max()) == max_sum - bias <= sc.I16_MAX
    assert int(S16.min()) >= -bias >= -sc.I16_MAX
    got = sc.agg_up_wta(C[None, top:], S16, params, bias, local=LOCAL)
    assert torch.equal(got[0], ts.sgbm_tile(C, params, top, bottom))
