"""The tile matcher (K9's plain version ``ops/sgbm.py:sgbm_tile``, its
wrapper ``sgbm_tile_cuda`` on CPU tensors, and the sharded path's tile
route ``_sgbm_cuda_tile``) against the JAX package, bitwise.

The reference for a slab with halos is the JAX package's own halo-mode
pieces on the same rows of the jnp cost volume: its horizontal scans on
the tile's rows, its down scan from the top halo, its up scan from the
bottom halo (``parallel/sharded.py:_scan_h``, ``_scan_v``), then its
``wta`` and ``lr_check``: what ``sgbm_tile_pallas`` computes. The Pallas
tile in interpret mode is too slow to run here."""

import dataclasses
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu.parallel import sharded as jsh
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.parallel import sharded as tsh

KW = dict(num_disparities=16, block_size=3, p1=72, p2=288,
          speckle_window_size=0)
H, W = 40, 48


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -5, axis=1)
                    + rng.normal(0, 3, (H, W)), 0, 255).astype(np.float32)
    return left, right


def volume(images, params):
    cap = params.pre_filter_cap
    lt, rt = (ts.sobel_clip(torch.tensor(a), cap) for a in images)
    return ts.cost_volume(lt, rt, params)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def jax_tile(C, params, start, local, halos):
    """The JAX halo mode's matcher on rows [start, start + local) of the
    full (H, W, D) jnp cost volume C, halos (top, bottom) rows deep."""
    top, bottom = halos
    P1, P2 = jnp.float32(params.P1), jnp.float32(params.P2)
    diag = params.num_paths == 8
    own = C[start:start + local]
    S = (jsh._scan_h(own, P1, P2, reverse=False)
         + jsh._scan_h(own, P1, P2, reverse=True)
         + jsh._scan_v(C[start - top:start + local], P1, P2, reverse=False,
                       keep=local, with_diag=diag)
         + jsh._scan_v(C[start:start + local + bottom], P1, P2, reverse=True,
                       keep=local, with_diag=diag))
    disp, valid = js.wta(S, params)
    valid = js.lr_check(S, disp, valid, params)
    return jnp.where(valid, disp, -1.0)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_no_halo_equals_sgbm(images, num_paths):
    """Halos 0 on the whole volume: the matcher itself, also batched."""
    params = SGBMParams(num_paths=num_paths, **KW)
    C = volume(images, params)
    want = ts.sgbm(*map(torch.tensor, images), params)
    assert torch.equal(ts.sgbm_tile(C, params), want)
    got = sc.sgbm_tile_cuda(C[None].to(torch.int16), params)
    assert got.shape == (1, H, W) and torch.equal(got[0], want)
    both = ts.sgbm_tile(torch.stack([C, C.flip(0)]), params)
    assert torch.equal(both[0], want)
    assert torch.equal(both[1], ts.sgbm_tile(C.flip(0), params))


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("start,local,halos", [
    (8, 16, (8, 8)), (13, 17, (3, 5)), (16, 24, (16, 0)), (1, 30, (1, 9)),
])
def test_halo_slab_matches_jax_halo_mode(images, num_paths, start, local,
                                         halos):
    """A tile's slab with its halo rows cut from the full volume gives the
    JAX halo mode's rows bitwise, through the plain version and through
    the wrapper's CPU route (int16 slab)."""
    params = SGBMParams(num_paths=num_paths, **KW)
    C = volume(images, params)
    top, bottom = halos
    slab = C[start - top:start + local + bottom]
    want = np.asarray(jax_tile(jnp.asarray(C.numpy()),
                               JaxParams(num_paths=num_paths, **KW), start,
                               local, halos))
    got = ts.sgbm_tile(slab, params, top, bottom)
    assert got.shape == (local, W)
    np.testing.assert_array_equal(got.numpy(), want)
    got = sc.sgbm_tile_cuda(slab[None].to(torch.int16).contiguous(), params,
                            top, bottom)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_zero_rows_are_the_path_start(images):
    """Zero cost rows beyond the image reproduce the fresh path start of
    the whole frame: the edge tiles of the halo mode are exact."""
    params = SGBMParams(**KW)
    C = volume(images, params)
    want = ts.sgbm_tile(C, params)
    z = torch.zeros_like(C[:8])
    assert torch.equal(ts.sgbm_tile(torch.cat([z, C, z[:3]]), params, 8, 3),
                       want)


@pytest.mark.parametrize("n_tile,halo", [(2, 20), (4, 40), (4, 10)])
def test_cuda_tile_route_assembles_the_frame(images, n_tile, halo):
    """The sharded path's tile route (Sobel, the clamped row gather, the
    cost kernel's plain version, zeroed out-of-image rows, the rounded
    halo) tile by tile: with halo >= H the tiles cover the frame and give
    ``sgbm`` bitwise; with a shorter halo each tile equals the JAX halo
    mode's rows at the rounded halo."""
    params = SGBMParams(**KW)
    left, right = (torch.tensor(a) for a in images)
    h = H // n_tile
    tiles = [tsh._sgbm_cuda_tile(left, right, params, k, n_tile, h, halo)
             for k in range(n_tile)]
    got = torch.cat(tiles)
    if halo >= H:
        assert torch.equal(got, ts.sgbm(left, right, params))
        return
    r = halo + (-(h + halo)) % 8
    C = jnp.asarray(volume(images, params).numpy())
    jparams = JaxParams(**KW)
    for k, tile in enumerate(tiles):
        top, bottom = min(r, k * h), min(r, H - (k + 1) * h)
        want = jax_tile(C, jparams, k * h, h, (top, bottom))
        np.testing.assert_array_equal(tile.numpy(), np.asarray(want))


def test_tile_limits():
    params = SGBMParams(**KW)
    C = torch.zeros((1, 10, 20, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="4 or 8 paths"):
        sc.sgbm_tile_cuda(C, dataclasses.replace(params, num_paths=2))
    with pytest.raises(ValueError, match="leave no rows"):
        ts.sgbm_tile(C, params, 5, 5)
    with pytest.raises(ValueError, match="leave no rows"):
        ts.sgbm_tile(C, params, -1, 0)
