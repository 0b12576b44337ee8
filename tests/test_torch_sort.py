"""The port's sort family (ops/sort.py, the CPU path of ops/sort_cuda.py)
and the seeded keep (ops/sgbm.py) against the JAX package's sort_tpu.py and
sgbm_pallas.py kernels in interpret mode, and against numpy.

Every output is an integer or a boolean and is compared bitwise (tolerance
0), with one stated exception, the values of a pair sort among equal keys:
the TPU's bitonic network keeps no input order on a tie, the port's sort is
stable. Against the JAX pair sorts the keys are compared bitwise, the
values bitwise after a lexicographic (key, value) sort of both outputs,
and bitwise as they are where a key is unique. JAX calls are jitted and
cached per shape, so that each JAX kernel compiles once per shape."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_depth_ruler_tpu.ops import sgbm_pallas as sp
from stereo_depth_ruler_tpu.ops import sort_tpu as st
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as tc
from stereo_depth_ruler_tpu_torch.ops import sort as so
from stereo_depth_ruler_tpu_torch.ops import sort_cuda as sc
from test_speckle_bound import _serpentine

# the small shapes of the sort tests: (batch, H, W); (40, 70) packs into
# R = 4 rows of L = 1024, the others into one row
SHAPES = {"8x128": (1, 8, 128), "23x41": (1, 23, 41), "40x70": (1, 40, 70),
          "3x24x40": (3, 24, 40)}
# a packed frame of several of sorted_runs.cu's 2048-position tiles (n2 =
# 8192, R = 8): frame 0 holds one label on 3000 pixels, whose sorted run
# crosses the tile edge at 4096, frame 1 one label everywhere, a run of
# the whole frame
TILED = {"2x64x128": (2, 64, 128)}


def labels_of(case, hi=None):
    """Seeded int32 labels with repeats, a quarter of them the sentinel H*W
    (invalid pixels), and a few large keys below 2**30 (and the TILED
    cases' long runs)."""
    B, H, W = {**SHAPES, **TILED}[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    lab = rng.integers(0, hi or max(H * W // 8, 2), (B, H, W))
    lab[rng.uniform(size=lab.shape) < 0.25] = H * W
    lab.flat[rng.integers(0, lab.size, 3)] = [2 ** 30 - 1, 2 ** 29,
                                              2 ** 24 + 5]
    if case in TILED:
        lab[0].flat[rng.choice(H * W, 3000, replace=False)] = (hi or
                                                               H * W // 8) // 2
        lab[1] = 7
    return lab.astype(np.int32)


def interpret(fn):
    """fn jitted (static arguments by keyword) and run in interpret mode."""
    @functools.wraps(fn)
    def run(*args, **static):
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(_jitted(fn, tuple(sorted(static.items())))(
                *map(jnp.asarray, args)))
    return run


@functools.lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


@interpret
def jax_sort_single(key, *, n2, L):
    return st._bitonic_sort_single(key, n2, L)


@interpret
def jax_sort_staged(key, val, *, n2, L):
    return jnp.stack(st._bitonic_sort_staged(key, val, n2, L))


@interpret
def jax_sort_fused(key, val, *, n2, L):
    return jnp.stack(st._bitonic_sort_fused(key, val, n2, L))


@interpret
def jax_sizes_sorted(skey, sidx, *, n2, L):
    """_counts_batched's sizes_sorted: its scan's pallas_call
    (sort_tpu.py:364-375) on the pair-sorted blocks."""
    from jax.experimental import pallas as pl
    B, R, _ = skey.shape
    spec = pl.BlockSpec((1, R, L), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    sizes, _ = pl.pallas_call(
        functools.partial(st._sizes_scan_kernel, n2=n2, L=L),
        grid=(B,), in_specs=[spec] * 2, out_specs=(spec,) * 2,
        out_shape=(jax.ShapeDtypeStruct((B, R, L), jnp.int32),) * 2,
    )(skey, sidx)
    return sizes


@interpret
def jax_counts(lab):
    return jax.vmap(st.equal_value_counts_pallas)(lab)


@interpret
def jax_keep(lab, *, max_size):
    return jax.vmap(lambda l: st.speckle_keep_pallas(l, max_size))(lab)


@interpret
def jax_roots(skey, *, n2, L, max_size):
    return st.large_run_roots(skey, n2, L, max_size)


@interpret
def jax_propagate(lab, seed, *, max_iters):
    return sp._propagate_keep_batched(lab, seed, max_iters)


@interpret
def jax_seeded(lab, *, max_size):
    return jax.vmap(lambda l: sp.speckle_keep_seeded(l, max_size))(lab)


def packed(case, **kw):
    key, n, n2, L, R = so.pack_batched(torch.tensor(labels_of(case, **kw)))
    return key, n, n2, L, R


def lexsorted(key, val):
    """(key, val) of each frame in lexicographic order."""
    k, v = key.reshape(key.shape[0], -1), val.reshape(val.shape[0], -1)
    order = [np.lexsort((vb, kb)) for kb, vb in zip(k, v)]
    return (np.stack([kb[o] for kb, o in zip(k, order)]),
            np.stack([vb[o] for vb, o in zip(v, order)]))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_sort_keys_vs_bitonic_single(case):
    """Tolerance 0: the key-only sort equals row 6's bitonic sort."""
    key, n, n2, L, R = packed(case)
    got = so.sort_keys(key)
    assert got.shape == key.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  jax_sort_single(key.numpy(), n2=n2, L=L))
    assert torch.equal(sc.sort_keys(key), got)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_sort_pairs_vs_bitonic_staged_and_fused(case):
    """Rows 9 and 11 under the tie rule (module docstring), tolerance 0."""
    key, n, n2, L, R = packed(case, hi=40)
    rng = np.random.default_rng(n)
    val = torch.tensor(rng.integers(0, 2 ** 31 - 1, key.shape,
                                    dtype=np.int32))
    skey, sval = so.sort_pairs(key, val)
    ref = jax_sort_staged(key.numpy(), val.numpy(), n2=n2, L=L)
    fused = np.stack([jax_sort_fused(k, v, n2=n2, L=L)
                      for k, v in zip(key.numpy(), val.numpy())], axis=1)
    flat_k = skey.numpy().reshape(key.shape[0], -1)
    for jk, jv in (ref, fused):
        np.testing.assert_array_equal(skey.numpy(), jk)
        for a, b in zip(lexsorted(skey.numpy(), sval.numpy()),
                        lexsorted(jk, jv)):
            np.testing.assert_array_equal(a, b)
        for b in range(key.shape[0]):
            u, counts = np.unique(flat_k[b], return_counts=True)
            uniq = np.isin(flat_k[b], u[counts == 1])
            np.testing.assert_array_equal(
                sval.numpy().reshape(key.shape[0], -1)[b][uniq],
                jv.reshape(key.shape[0], -1)[b][uniq])
    # stable: equal keys keep their values in input order
    flat_v = val.numpy().reshape(key.shape[0], -1)
    order = np.argsort(key.numpy().reshape(key.shape[0], -1), axis=1,
                       kind="stable")
    np.testing.assert_array_equal(
        sval.numpy().reshape(key.shape[0], -1),
        np.take_along_axis(flat_v, order, axis=1))
    got = sc.sort_pairs(key, val)
    assert torch.equal(got[0], skey) and torch.equal(got[1], sval)


@pytest.mark.parametrize("case", sorted(SHAPES) + sorted(TILED))
def test_run_sizes_vs_sizes_scan(case):
    """Row 10's sizes_sorted on the JAX pair sort's output, tolerance 0;
    at 2x64x128 a run crosses a tile edge and one spans the frame."""
    key, n, n2, L, R = packed(case)
    pos = so.positions(key)
    jk, jv = jax_sort_staged(key.numpy(), pos.numpy(), n2=n2, L=L)
    want = jax_sizes_sorted(jk, jv, n2=n2, L=L)
    skey = torch.tensor(jk)
    got = so.run_sizes(skey)
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
    assert torch.equal(sc.run_sizes(skey), got)
    if case in TILED:   # the runs the case is made of
        assert got[0, 4095] == got[0, 4096] >= 3000 and (got[1] == n2).all()
    # written back through the (tie-independent) source indices
    through = so.run_sizes(skey, torch.tensor(jv), n)
    assert torch.equal(sc.run_sizes(skey, torch.tensor(jv), n), through)
    lab = labels_of(case).reshape(key.shape[0], -1)
    np.testing.assert_array_equal(
        through.numpy(),
        np.stack([np.unique(f, return_counts=True)[1][
            np.unique(f, return_inverse=True)[1]] for f in lab]))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_equal_value_counts(case):
    """Against np.bincount at every shape and equal_value_counts_pallas at
    the one with R > 1 (one Pallas compile keeps the file short);
    tolerance 0."""
    lab = labels_of(case)
    got = so.equal_value_counts(torch.tensor(lab))
    assert got.shape == lab.shape
    want = np.stack([np.unique(f, return_counts=True)[1][
        np.unique(f, return_inverse=True)[1]].reshape(f.shape) for f in lab])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sc.equal_value_counts(torch.tensor(lab)), got)
    if case == "40x70":
        np.testing.assert_array_equal(got.numpy(), jax_counts(lab))
    small = lab.copy()
    small[small >= 2 ** 24] = 0        # bincount needs a short axis
    np.testing.assert_array_equal(
        so.equal_value_counts(torch.tensor(small)).numpy(),
        np.stack([np.bincount(f.reshape(-1))[f] for f in small]))


@pytest.mark.parametrize("max_size", [1, 4, 50])
def test_speckle_keep_sorted_vs_pallas(max_size):
    """speckle_keep_pallas on every pixel (the sentinel's too), tolerance 0,
    at the (40, 70) frame (R = 4)."""
    lab = labels_of("40x70", hi=60)
    got = so.speckle_keep_sorted(torch.tensor(lab), max_size)
    assert got.dtype == torch.bool and got.shape == lab.shape
    np.testing.assert_array_equal(got.numpy(),
                                  jax_keep(lab, max_size=max_size))
    assert torch.equal(sc.speckle_keep_sorted(torch.tensor(lab), max_size),
                       got)


@pytest.mark.parametrize("max_size", [3, 8, 50])
@pytest.mark.parametrize("case", ["40x70", "3x24x40", "2x64x128"])
def test_sorted_labels_and_large_run_roots(case, max_size):
    """sorted_labels and row 7's roots, tolerance 0: the port's ``slots``
    columns equal JAX's first ``slots``, JAX's lane padding is all -1. The
    pad INF and the sentinel H*W may be roots here."""
    lab = labels_of(case, hi=400)
    skey, n, n2, L, R = so.sorted_labels(torch.tensor(lab))
    key = so.pack_batched(torch.tensor(lab))[0]
    np.testing.assert_array_equal(skey.numpy(),
                                  jax_sort_single(key.numpy(), n2=n2, L=L))
    got = so.large_run_roots(skey, n2, L, max_size)
    slots = so.roots_slots(L, max_size)
    assert got.shape == (lab.shape[0], R, slots)
    want = jax_roots(skey.numpy(), n2=n2, L=L, max_size=max_size)
    np.testing.assert_array_equal(got.numpy(), want[..., :slots])
    assert (want[..., slots:] == -1).all()
    assert (got >= 0).any()
    assert torch.equal(sc.large_run_roots(skey, n2, L, max_size), got)
    s2 = sc.sorted_labels(torch.tensor(lab))
    assert torch.equal(s2[0], skey) and s2[1:] == (n, n2, L, R)


def snake_labels():
    """Labels of two 64x96 frames that need many rounds: the serpentine's
    one component (label 0) plus a few separate blobs; and sparse seeds."""
    d = _serpentine(64, 96, pitch=2)
    lab = np.where(d >= 0, 0, 64 * 96).astype(np.int32)
    lab = np.stack([lab, lab.copy()])
    lab[1, 1:4, 10:30] = 96 + 10          # a row-run blob between turns
    rng = np.random.default_rng(5)
    seed = (rng.uniform(size=lab.shape) < 0.002).astype(np.int32)
    seed[0, 0, 0] = 0
    seed[0, 60, 50] = 1
    return lab, seed


@pytest.mark.parametrize("max_iters", [0, 1, 2])
def test_propagate_keep_vs_pallas(max_iters):
    """Row 5, converged and capped (round for round), tolerance 0."""
    lab, seed = snake_labels()
    got = ts.propagate_keep(torch.tensor(lab), torch.tensor(seed), max_iters)
    np.testing.assert_array_equal(
        got.numpy(), jax_propagate(lab, seed, max_iters=max_iters))
    assert torch.equal(tc.propagate_keep(torch.tensor(lab),
                                         torch.tensor(seed), max_iters), got)
    full = ts.propagate_keep(torch.tensor(lab), torch.tensor(seed))
    assert torch.equal(got, full) == (max_iters == 0)


def test_speckle_keep_seeded_vs_pallas():
    """sgbm_pallas.speckle_keep_seeded on converged labels of noisy maps,
    tolerance 0; the sentinel reads False, valid pixels equal the
    histogram keep."""
    rng = np.random.default_rng(8)
    disp = rng.integers(0, 5, (3, 24, 40)).astype(np.float32)
    disp[rng.uniform(size=disp.shape) < 0.3] = -1.0
    lab = ts.speckle_labels(torch.tensor(disp), 1.0)
    got = ts.speckle_keep_seeded(lab, 5)
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got.numpy(),
                                  jax_seeded(lab.numpy(), max_size=5))
    assert torch.equal(tc.speckle_keep_seeded(lab, 5), got)
    for max_size in (3, 5, 8):
        assert torch.equal(ts.speckle_keep_seeded(lab, max_size),
                           ts._keep_mask(lab, max_size))
