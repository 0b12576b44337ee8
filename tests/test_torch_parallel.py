"""The port's sharded path (``stereo_depth_ruler_tpu_torch.parallel``) on a
gloo world of eight CPU processes against the JAX package's on the
8-virtual-device CPU mesh, case by case as tests/test_parallel.py, on its
``tiny_pair`` and PARAMS.

The world is spawned once for the module (tests/torch_parallel_cases.py,
which imports no JAX, runs every case on every rank) with a time limit,
so that a hang fails instead of running into the suite's. The JAX side
runs in this process: its jnp matcher, its jnp halo mode and its
pipeline step. Bitwise: the exact wavefront, the D split, their
composition, the halo modes, the tile route (the kernels' plain versions
on CPU tensors, against the jnp halo mode at the halo the route rounds
to) and the pipeline step's disparity; xyz at rtol 1e-5 (XLA may contract
the multiply-adds), with inf and NaN in the same places; the WLS steps
within the JAX package's WLS bound (rtol 2e-3, atol 2e-2) with equal
invalid masks."""

import dataclasses
from functools import partial

import numpy as np
import pytest

import jax
import torch

import torch_parallel_cases as cases
from stereo_depth_ruler_tpu.calib.config import StereoRig as JaxRig
from stereo_depth_ruler_tpu.ops import sgbm as js
from stereo_depth_ruler_tpu.ops.remap import build_remap_grids as jgrids
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu.parallel import sharded as jsh
from stereo_depth_ruler_tpu.parallel.mesh import make_mesh as jmesh
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as ts
from stereo_depth_ruler_tpu_torch.parallel import dryrun, mesh as tmesh
from stereo_depth_ruler_tpu_torch.parallel import sharded as tsh

PARAMS = SGBMParams(**cases.PARAMS)
JPARAMS = JaxParams(**cases.PARAMS)
STEP = dataclasses.replace(JPARAMS, speckle_window_size=0)
RIG = dict(width=48, height=32, focal=50.0, baseline_mm=30.0)
Q = np.array([[1.0, 0, 0, -24.0], [0, 1.0, 0, -16.0],
              [0, 0, 0, 50.0], [0, 0, 1.0 / 30.0, 0]])
RTOL = 1e-5
WLS_RTOL, WLS_ATOL = 2e-3, 2e-2
WORLD = 8
TIMEOUT = 240.0


@pytest.fixture(scope="module")
def pair(tiny_pair):
    left, right, _ = tiny_pair
    return np.float32(left), np.float32(right)


@pytest.fixture(scope="module")
def single(pair):
    return np.asarray(jax.jit(partial(js.sgbm, params=JPARAMS))(*pair))


@pytest.fixture(scope="module")
def world(pair):
    """Each rank's results of tests/torch_parallel_cases.py, rank order."""
    left, right = pair
    lefts, rights = cases.frames(left, right)
    return dryrun.spawn_world(cases.run_cases, WORLD, left, right, lefts,
                              rights, Q, RIG, timeout=TIMEOUT,
                              device_type="cpu")


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")


def jax_halo(pair, tile, disp, halo, apply_speckle=True):
    """The JAX package's jnp halo mode (jitted: run op by op, its scans
    take half a minute here)."""
    _need(tile * disp)
    fn = partial(jsh.sgbm_sharded, params=JPARAMS,
                 mesh=jmesh(tile=tile, disp=disp), halo=halo, kernel="jnp",
                 apply_speckle=apply_speckle)
    return np.asarray(jax.jit(fn)(*pair))


def jax_step(pair, mesh, **kw):
    _need(int(np.prod(mesh)))
    lefts, rights = cases.frames(*pair)
    out = jsh.pipeline_step_sharded(lefts, rights, kw.pop("Q", Q),
                                    kw.pop("params", STEP),
                                    jmesh(*mesh), kernel="jnp", **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def port_frames(world, key, ranks_per_group):
    """The step's (N, ...) outputs from each frame group's first rank."""
    groups = [world[r][key] for r in range(0, WORLD, ranks_per_group)
              if key in world[r]]
    return {k: np.concatenate([g[k] for g in groups]) for k in groups[0]}


def test_workers_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world)


@pytest.mark.parametrize("name", ["exact_tile4", "exact_disp4",
                                  "exact_tile2_disp2"])
def test_exact_modes_bitwise(world, single, name):
    """The exact wavefront (tile=4), the D split (disp=4, its per-step
    all_reduce and neighbour lanes) and both composed (tile=2 x disp=2)
    equal the single-device matcher bitwise, on every rank."""
    for r in world:
        np.testing.assert_array_equal(r[name], single)


def test_dshard_local_slab_is_slice():
    """The local cost slab really is a D slice, equal to the JAX
    package's bitwise."""
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (16, 32)).astype(np.float32)
    right = np.roll(left, -3, axis=1).astype(np.float32)
    lt, rt = torch.tensor(left), torch.tensor(right)
    full = tsh._local_cost_slab(lt, rt, PARAMS, 0, 16).numpy()
    assert full.shape == (16, 32, 16)
    np.testing.assert_array_equal(
        full, np.asarray(jsh._local_cost_slab(left, right, JPARAMS, 0, 16)))
    for k in range(4):
        part = tsh._local_cost_slab(lt, rt, PARAMS, 0, 16, disp_idx=k,
                                    n_disp=4).numpy()
        assert part.shape == (16, 32, 4)
        np.testing.assert_array_equal(part, full[:, :, 4 * k:4 * k + 4])
    # a middle tile of a 4-tile split, clamped context rows
    np.testing.assert_array_equal(
        tsh._local_cost_slab(lt, rt, PARAMS, 1, 4, disp_idx=2,
                             n_disp=4).numpy(),
        np.asarray(jsh._local_cost_slab(left, right, JPARAMS, 1, 4,
                                        disp_idx=2, n_disp=4)))


@pytest.mark.parametrize("name,tile,disp,halo", [
    ("halo16_tile2_disp2", 2, 2, 16),     # full-coverage halo
    ("halo8_tile4", 4, 1, 8),
])
def test_halo_modes_bitwise(world, pair, single, name, tile, disp, halo):
    """Halo mode equals the JAX package's jnp halo mode bitwise; with a
    full-coverage halo (halo >= h_local) it equals the single-device
    matcher too."""
    want = jax_halo(pair, tile, disp, halo)
    for r in world:
        np.testing.assert_array_equal(r[name], want)
    if halo >= pair[0].shape[0] // tile:
        np.testing.assert_array_equal(want, single)


@pytest.mark.parametrize("name,tile,halo,speckle", [
    ("route_halo5_tile2", 2, 8, True),          # halo 5 rounds up to 8
    ("route_halo16_tile2", 2, 16, True),
    ("route_halo8_tile4_nospeckle", 4, 8, False),
])
def test_tile_route_matches_jax_halo_mode(world, pair, name, tile, halo,
                                          speckle):
    """The tile route (kernel="cuda": the slab built by the cost kernel's
    plain version, sgbm_tile_cuda's plain version) equals the JAX jnp halo
    mode at the halo it rounds to (h_local + halo a multiple of 8)."""
    want = jax_halo(pair, tile, 1, halo, apply_speckle=speckle)
    for r in world:
        if name in r:
            np.testing.assert_array_equal(r[name], want)


def test_tile_route_one_tile_equals_sgbm(world, single):
    for r in world:
        np.testing.assert_array_equal(r["route_tile1"], single)


def test_mesh_shapes_and_initialize(world, monkeypatch):
    for r in world:
        assert r["mesh_shape"] == {"frame": 2, "tile": 2, "disp": 2}
        assert "need 64 processes, have 8" in r["too_big"]
        assert r["global_shape"] == (2, 2, 2)
        assert r["initialize_again"] is False      # a world is running
    for var in ("SDR_COORDINATOR", "SDR_NUM_PROCESSES", "SDR_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_distributed() is False  # single process
    with pytest.raises(ValueError, match="not initialized"):
        tmesh.make_mesh(device_type="cpu")


def test_frame_sharded_pipeline_step(world, pair):
    """(frame, tile, disp) = (2, 2, 2), halo 8: each frame group returns
    its own frame; the disparity equals the JAX step's bitwise, xyz at rtol
    1e-5 with inf and NaN in the same places."""
    got = port_frames(world, "step", 4)
    want = jax_step(pair, (2, 2, 2), halo=8)
    H, W = pair[0].shape
    assert got["disparity"].shape == (2, H, W)
    assert got["xyz"].shape == (2, H, W, 3)
    assert [world[r]["frame"] for r in (0, 4)] == [0, 1]
    np.testing.assert_array_equal(got["disparity"], want["disparity"])
    g, w = got["xyz"], want["xyz"]
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL)
    assert (got["disparity"] > 0).mean() > 0.5


@pytest.mark.parametrize("key,mesh,per_group,kw", [
    ("step_wls", (2, 2, 2), 4, dict(params=STEP)),
    ("step_wls_route", (2, 2, 1), 2, dict(params=JPARAMS,
                                          apply_speckle=True)),
])
def test_wls_pipeline_step(world, pair, key, mesh, per_group, kw):
    """use_wls with rects (the undistorted synthetic rig's grids): the
    plain route on (2, 2, 2), and the tile route with the speckle filter
    on (2, 2, 1); the filtered disparity within the WLS bound of the JAX
    step, the invalid masks equal."""
    rig = JaxRig.synthetic(**RIG)
    got = port_frames(world, key, per_group)
    want = jax_step(pair, mesh, halo=8, use_wls=True, rects=jgrids(rig),
                    Q=rig.Q, **kw)
    d, wd = got["disparity"], want["disparity"]
    np.testing.assert_array_equal(d < 0, wd < 0)
    m = wd >= 0
    assert m.mean() > 0.9                       # the WLS filter inpaints
    np.testing.assert_allclose(d[m], wd[m], rtol=WLS_RTOL, atol=WLS_ATOL)


def test_aggregator_hook():
    """sgbm(aggregator=) and compute_disparity_pair(aggregator=) run the
    plain matcher with the hook, as the JAX package's do: a 4-path
    aggregator under an 8-path configuration gives the JAX output
    bitwise."""
    rng = np.random.default_rng(4)
    left = rng.uniform(0, 255, (24, 40)).astype(np.float32)
    right = np.roll(left, -5, axis=1)

    def t_agg(cost, P1, P2, n):
        return ts.aggregate_paths(cost, P1, P2, 4)

    def j_agg(cost, P1, P2, n):
        return js.aggregate_paths(cost, P1, P2, 4)

    got = ts.sgbm(torch.tensor(left), torch.tensor(right), PARAMS,
                  aggregator=t_agg).numpy()
    want = np.asarray(jax.jit(partial(js.sgbm, params=JPARAMS,
                                      aggregator=j_agg))(left, right))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, ts.sgbm(torch.tensor(left),
                                           torch.tensor(right),
                                           PARAMS).numpy())
    dl, dr = ts.compute_disparity_pair(torch.tensor(left),
                                       torch.tensor(right), PARAMS,
                                       aggregator=t_agg)
    jl, jr = jax.jit(partial(js.compute_disparity_pair, params=JPARAMS,
                             aggregator=j_agg))(left, right)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(jr))


def test_dryrun_multichip_small():
    """The port of __graft_entry__.dryrun_multichip on four CPU processes,
    (frame, tile, disp) = (1, 2, 2), at 32x64 with 16 disparities."""
    msg = dryrun.dryrun_multichip(4, tile_rows=16, width=64, num_disp=16,
                                  frames_per_group=1, timeout=TIMEOUT,
                                  device_type="cpu")
    assert msg.startswith("dryrun_multichip ok: mesh(frame=1, tile=2, "
                          "disp=2) on cpu"), msg
    assert "tile route on a 2-member tile mesh ok" in msg


def test_dryrun_cuda_needs_a_card_per_rank():
    """dryrun_multichip runs on the cards by default: one rank per card,
    refused before any process starts where the machine has fewer."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has a card for each rank")
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards"):
        dryrun.dryrun_multichip(2, tile_rows=16, width=64, num_disp=16)
    with pytest.raises(ValueError, match="device_type"):
        dryrun.spawn_world(print, 1, device_type="tpu")
