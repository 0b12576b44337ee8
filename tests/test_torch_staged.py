"""The port's staged matcher chain (ops/sgbm.py: cost_down, wta_lr3,
sgbm_staged, the three transposes; and the CPU path of their wrappers in
ops/sgbm_cuda.py) against the JAX package's Pallas kernels in interpret
mode, the jnp matcher and numpy.

Every value is an exact small integer or a bit pattern moved unchanged, so
every comparison is bitwise (tolerance 0). The Pallas volumes are (H, D, W)
and are permuted to the port's (H, W, D). JAX calls are jitted and cached
per shape and parameter set, so that each Pallas kernel compiles once."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops import sgbm_pallas as sp
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as tc


def params_of(num_paths=8, min_disp=0, **kw):
    return SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                      speckle_window_size=0, num_paths=num_paths,
                      min_disparity=min_disp, **kw)


def jp(params):
    return JaxParams(**dataclasses.asdict(params))


def T(a):
    return torch.tensor(np.asarray(a))


def eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def hwd(a):
    """A Pallas (H, D, W) volume in the port's (H, W, D) layout."""
    return np.transpose(np.asarray(a), (0, 2, 1))


@functools.lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


def interpret(fn):
    """fn jitted (static arguments by keyword) and run in interpret mode;
    returns numpy arrays."""
    @functools.wraps(fn)
    def run(*args, **static):
        with pltpu.force_tpu_interpret_mode():
            out = _jitted(fn, tuple(sorted(static.items())))(
                *map(jnp.asarray, args))
        return jax.tree.map(np.asarray, out)
    return run


@interpret
def jax_staged_chain(left, right, *, params):
    """The chain as tests/test_sgbm_pallas.py composes it: the fused cost +
    down kernel, the horizontal passes on the transposed volume, the up
    pass, and wta_lr_pallas with the LR check on and off."""
    cap, P1, P2 = params.pre_filter_cap, params.P1, params.P2
    with_diag = params.num_paths == 8
    lt = js.sobel_clip(left, cap)
    rt = js.sobel_clip(right, cap)
    C, S_down = sp.build_cost_down_pallas(lt, rt, params, blk=8)
    Ct = jnp.transpose(C, (2, 1, 0))
    S_h = jnp.transpose(
        sp.directional_pass_pallas(Ct, P1, P2, False, False)
        + sp.directional_pass_pallas(Ct, P1, P2, True, False), (2, 1, 0))
    S_up = sp.directional_pass_pallas(C, P1, P2, True, with_diag)
    disp = [sp.wta_lr_pallas(S_down, S_up, S_h, params, apply_lr=lr)
            for lr in (True, False)]
    return lt, rt, C, S_down, S_up, S_h, disp[0], disp[1]


@interpret
def jax_sgbm(left, right, *, params):
    return js.sgbm(left, right, params), sp.sgbm_pallas(left, right, params)


@interpret
def jax_transposes(x):
    return (sp.transpose_vol_pallas(x), sp.transpose_leading_pallas(x),
            sp.transpose_dhw_to_wdh_pallas(x))


def wide_pair():
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (48, 160)).astype(np.float32)
    right = (np.roll(left, -5, axis=1)
             + rng.normal(0, 2, left.shape)).astype(np.float32)
    return left, right


@pytest.fixture(scope="module")
def pairs(tiny_pair):
    return {"tiny": (np.float32(tiny_pair[0]), np.float32(tiny_pair[1])),
            "wide": wide_pair()}


CASES = [("tiny", 8, 0), ("tiny", 8, 3), ("tiny", 4, 0), ("tiny", 4, 3),
         ("wide", 8, 0)]


@pytest.fixture(scope="module")
def chains(pairs):
    """The JAX chain's stages per case, computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            name, num_paths, md = case
            cache[case] = jax_staged_chain(
                *pairs[name], params=jp(params_of(num_paths, md)))
        return cache[case]
    return get


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-p{c[1]}-md{c[2]}")
def test_cost_down_vs_pallas(chains, case):
    lt, rt, C_j, Sd_j = chains(case)[:4]
    params = params_of(case[1], case[2])
    C, S_down = ts.cost_down(T(lt), T(rt), params)
    eq(C, hwd(C_j))
    eq(S_down, hwd(Sd_j))
    # the wrapper's CPU path: the same values as int16, batch of one
    C16, Sd16 = tc.cost_down(T(lt)[None], T(rt)[None], params)
    assert C16.dtype == Sd16.dtype == torch.int16
    eq(C16[0], hwd(C_j))
    eq(Sd16[0], hwd(Sd_j))


@pytest.mark.parametrize("apply_lr", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-p{c[1]}-md{c[2]}")
def test_wta_lr3_vs_pallas(chains, case, apply_lr):
    out = chains(case)
    Sd, Su, Sh = (T(hwd(a)) for a in out[3:6])
    want = out[6] if apply_lr else out[7]
    params = params_of(case[1], case[2])
    eq(ts.wta_lr3(Sd, Su, Sh, params, apply_lr), want)
    eq(tc.wta_lr3(Sd[None], Su[None], Sh[None], params, apply_lr)[0], want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-p{c[1]}-md{c[2]}")
def test_partial_sums_vs_pallas(chains, case):
    """The int16 partial sums of the wrapper's CPU path (K2 on an int16 S)
    against the Pallas passes, and their total against the int32 S."""
    out = chains(case)
    params = params_of(case[1], case[2])
    C = T(hwd(out[2]))[None]
    assert C.dtype == torch.int16
    S_h = tc.aggregate_i16(C, params, [(0, 1), (0, -1)])
    S_up = tc.aggregate_i16(C, params, ts.up_dirs(params.num_paths))
    S_down = tc.aggregate_i16(C, params, ts.down_dirs(params.num_paths))
    assert S_h.dtype == S_up.dtype == S_down.dtype == torch.int16
    eq(S_down[0], hwd(out[3]))
    eq(S_up[0], hwd(out[4]))
    eq(S_h[0], hwd(out[5]))
    S32 = tc.aggregate(C, params)
    assert S32.dtype == torch.int32
    eq(S_down.int() + S_up.int() + S_h.int(), S32)


@pytest.mark.parametrize("case", [("tiny", 8, 0), ("tiny", 4, 3),
                                  ("wide", 8, 0)],
                         ids=lambda c: f"{c[0]}-p{c[1]}-md{c[2]}")
def test_sgbm_staged_vs_jax(pairs, case):
    name, num_paths, md = case
    left, right = pairs[name]
    params = params_of(num_paths, md)
    d_jnp, d_pallas = jax_sgbm(left, right, params=jp(params))
    got = ts.sgbm_staged(T(left), T(right), params)
    eq(got, d_jnp)
    eq(got, d_pallas)
    eq(got, ts.sgbm(T(left), T(right), params))
    eq(tc.sgbm_staged_cuda(T(left)[None], T(right)[None], params)[0], d_jnp)


def test_sgbm_staged_speckle_and_lr_off(pairs):
    left, right = (T(a) for a in pairs["tiny"])
    params = SGBMParams(num_disparities=16, speckle_window_size=20)
    eq(ts.sgbm_staged(left, right, params), ts.sgbm(left, right, params))
    eq(tc.sgbm_staged_cuda(left[None], right[None], params)[0],
       ts.sgbm(left, right, params))
    eq(ts.sgbm_staged(left, right, params, apply_lr=False,
                      apply_speckle=False),
       ts.sgbm(left, right, params, apply_lr=False, apply_speckle=False))
    with pytest.raises(ValueError, match="4 or 8 paths"):
        ts.sgbm_staged(left, right, params_of(2))
    with pytest.raises(ValueError, match="4 or 8 paths"):
        tc.sgbm_staged_cuda(left[None], right[None], params_of(2))


def test_int16_range_guard(pairs):
    """A partial sum that could pass 32767 raises and never wraps: at block
    7 with P2 1000 three paths can reach 3 * (12348 + 1000), two paths fit."""
    left, right = (T(a)[None] for a in pairs["tiny"])
    big = SGBMParams(num_disparities=16, block_size=7, p1=100, p2=1000,
                     speckle_window_size=0)
    assert tc.path_sum_bound(big, 3) == 3 * (49 * 4 * 63 + 1000) > 32767
    assert tc.path_sum_bound(big, 2) < 32767
    assert tc.path_sum_bound(SGBMParams(), 3) == 3 * (6300 + 2400)
    lt = ts.sobel_clip(left, 63)
    rt = ts.sobel_clip(right, 63)
    with pytest.raises(ValueError, match="int16"):
        tc.cost_down(lt, rt, big)
    with pytest.raises(ValueError, match="int16"):
        tc.sgbm_staged_cuda(left, right, big)
    C = tc.cost_volume(lt, rt, big)
    S16 = torch.empty_like(C)
    with pytest.raises(ValueError, match="int16"):
        tc.sgm_pass(C, S16, 1, 0, big.P1, big.P2, False,
                    sum_bound=tc.path_sum_bound(big, 3))
    with pytest.raises(ValueError, match="sum_bound"):
        tc.sgm_pass(C, S16, 1, 0, big.P1, big.P2, False)
    # two paths fit, and equal the int32 sum
    S_h = tc.aggregate_i16(C, big, [(0, 1), (0, -1)])
    S32 = torch.empty(C.shape, dtype=torch.int32)
    tc.sgm_pass(C, S32, 0, 1, big.P1, big.P2, False)
    tc.sgm_pass(C, S32, 0, -1, big.P1, big.P2, True)
    eq(S_h.int(), S32)
    # with 4 paths the vertical sums are single paths, and the chain runs
    four = dataclasses.replace(big, num_paths=4)
    eq(tc.sgbm_staged_cuda(left, right, four),
       tc.sgbm_cuda(left, right, four))


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("shape", [(16, 8, 128), (8, 16, 24)])
def test_transposes_vs_pallas(shape, dtype):
    rng = np.random.default_rng(shape[2])
    x = (rng.integers(-30000, 30000, shape).astype(np.int16)
         if dtype == "int16" else rng.normal(size=shape).astype(np.float32))
    want = jax_transposes(x)
    axes = ((2, 1, 0), (1, 0, 2), (2, 0, 1))
    fns = ((ts.transpose_vol, tc.transpose_vol),
           (ts.transpose_leading, tc.transpose_leading),
           (ts.transpose_dhw_to_wdh, tc.transpose_dhw_to_wdh))
    for w, ax, (plain_fn, wrapper) in zip(want, axes, fns):
        got = plain_fn(T(x))
        assert got.is_contiguous() and str(got.dtype) == f"torch.{dtype}"
        eq(got, w)
        eq(got, np.transpose(x, ax))
        eq(wrapper(T(x)), w)


def test_transposes_bfloat16_round_trip():
    """A 16-bit float passes through bit for bit (the JAX kernels once
    value-cast it): against the Pallas kernels on the same bits, and there
    and back."""
    rng = np.random.default_rng(3)
    x32 = rng.normal(size=(16, 8, 128)).astype(np.float32)
    xj = jnp.asarray(x32, jnp.bfloat16)
    x = torch.tensor(x32).to(torch.bfloat16)
    eq(x.view(torch.int16), np.asarray(xj).view(np.int16))
    want = jax_transposes(xj)
    for fn, w in zip((tc.transpose_vol, tc.transpose_leading,
                      tc.transpose_dhw_to_wdh), want):
        got = fn(x)
        assert got.dtype == torch.bfloat16
        eq(got.view(torch.int16), np.asarray(w).view(np.int16))
    eq(tc.transpose_vol(tc.transpose_vol(x)).view(torch.int16),
       x.view(torch.int16))
    back = tc.transpose_dhw_to_wdh
    eq(back(back(back(x))).view(torch.int16), x.view(torch.int16))
