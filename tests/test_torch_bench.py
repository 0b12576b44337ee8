"""The port's benchmark (``stereo_depth_ruler_tpu_torch/bench.py``) and
entry points (``entry.py``) against ``bench.py`` and ``__graft_entry__.py``
at the repo root, on the CPU (the kernels' plain versions).

The inputs are byte-equal; the flagship's and the sweep's disparity equal
the jnp matcher's bitwise, the depth and xyz at rtol 1e-5 (XLA and
PyTorch may order or contract the float multiply-adds differently); the
full pipeline's filtered disparity within the WLS bound (rtol 2e-3, atol
2e-2). The shape constants are patched small: 2 frames of 96x48 with 16
disparities."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stereo_depth_ruler_tpu.calib.config import StereoRig as JaxRig
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu.pipeline import PipelineConfig as JaxConfig
from stereo_depth_ruler_tpu.pipeline import StereoPipeline as JaxPipeline
from stereo_depth_ruler_tpu_torch import bench, entry
from stereo_depth_ruler_tpu_torch.parallel import dryrun
from stereo_depth_ruler_tpu_torch.utils import kernels

ROOT = Path(__file__).resolve().parent.parent
H, W, D = 48, 96, 16
RTOL = 1e-5
WLS_RTOL, WLS_ATOL = 2e-3, 2e-2


def _load(name):
    """A module at the repo root, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    return _load("bench")


@pytest.fixture(scope="module")
def jentry():
    return _load("__graft_entry__")


@pytest.fixture
def small(monkeypatch):
    """The bench's shape constants at 48x96x16."""
    monkeypatch.setattr(bench, "H", H)
    monkeypatch.setattr(bench, "W", W)
    monkeypatch.setattr(bench, "D", D)
    monkeypatch.setattr(bench, "SWEEP", (H, W, D))


@pytest.fixture(scope="module")
def inputs():
    """Two frames of the bench's scene at 96x48 (the port's renderer,
    byte-equal to the JAX package's)."""
    saved = (bench.H, bench.W)
    bench.H, bench.W = H, W
    try:
        return bench.make_inputs(batch=2)
    finally:
        bench.H, bench.W = saved


@pytest.fixture(scope="module")
def jax_forward(jentry):
    """The JAX flagship forward at 48x96x16, jitted once (the jnp matcher
    on the CPU)."""
    fwd, rig, params = jentry._flagship(H, W, D)
    return jax.jit(fwd), rig


def test_make_inputs_match_jax_bytes(jbench):
    rig, lefts, rights = bench.make_inputs(batch=2)
    jrig, jl, jr = jbench.make_inputs(batch=2)
    assert lefts.shape == (2, 720, 1280) and lefts.dtype == np.uint8
    assert lefts.tobytes() == jl.tobytes()
    assert rights.tobytes() == jr.tobytes()
    np.testing.assert_array_equal(rig.Q, jrig.Q)


def test_sweep_inputs_match_jax_expression():
    """bench.py's sweep arrays (bench.py:195-197) at a cut shape."""
    rng = np.random.default_rng(0)
    left = jnp.asarray(rng.uniform(0, 255, (36, 80)), jnp.float32)
    right = jnp.asarray(np.roll(np.asarray(left), -20, axis=1))
    mine = bench.sweep_inputs(36, 80)
    assert mine[0].dtype == mine[1].dtype == np.float32
    assert mine[0].tobytes() == np.asarray(left).tobytes()
    assert mine[1].tobytes() == np.asarray(right).tobytes()


def test_entry_example_pair_matches_jax(jentry):
    fn, (left, right) = entry.entry(device="cpu")
    _, (jl, jr) = jentry.entry()
    assert left.shape == (720, 1280) and left.device.type == "cpu"
    assert left.numpy().tobytes() == jl.tobytes()
    assert right.numpy().tobytes() == jr.tobytes()


def test_flagship_forward_matches_jax(jax_forward, inputs):
    jfwd, jrig = jax_forward
    fwd, rig, params = entry._flagship(H, W, D, device="cpu")
    np.testing.assert_array_equal(rig.Q, jrig.Q)
    _, lefts, rights = inputs
    l, r = np.float32(lefts[1]), np.float32(rights[1])
    disp, xyz = fwd(l, r)
    jd, jxyz = (np.asarray(a) for a in jfwd(l, r))
    assert disp.shape == (H, W) and xyz.shape == (H, W, 3)
    np.testing.assert_array_equal(disp.numpy(), jd)
    xyz = xyz.numpy()
    np.testing.assert_array_equal(np.isfinite(xyz), np.isfinite(jxyz))
    fin = np.isfinite(jxyz)
    np.testing.assert_allclose(xyz[fin], jxyz[fin], rtol=RTOL)


def test_full_pipeline_config_matches_jax(jentry):
    fn, (left, right) = entry.entry_full_pipeline(device="cpu")
    pipe = fn.__self__
    want = JaxConfig(sgbm=JaxParams(num_disparities=128, block_size=5,
                                    speckle_window_size=200,
                                    speckle_range=2),
                     downscale=1, use_wls=True, lr_mode="right_matcher")
    for f in dataclasses.fields(want):
        mine, ref = getattr(pipe.config, f.name), getattr(want, f.name)
        if f.name == "sgbm":
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        else:
            assert mine == ref, f.name
    assert pipe.rectify and (pipe.rig.width, pipe.rig.height) == (1280, 720)
    _, (jl, jr) = jentry.entry_full_pipeline()
    assert left.numpy().tobytes() == jl.tobytes()
    assert right.numpy().tobytes() == jr.tobytes()


def test_bench_flagship_matches_jnp(small, jax_forward, inputs):
    jfwd, _ = jax_forward
    rig, lefts, rights = inputs
    run = bench.bench_flagship(rig, lefts, rights, iters=1, device="cpu")
    assert run.fps > 0 and run.calls == 2 + bench.REPS
    assert len(run.event_ms) == len(run.host_ms) == bench.REPS
    assert run.peak_bytes is None and run.first_s > 0
    disp, z = run.first
    assert disp.shape == z.shape == (2, H, W)
    for i in range(2):
        jd, jxyz = (np.asarray(a) for a in jfwd(np.float32(lefts[i]),
                                                np.float32(rights[i])))
        np.testing.assert_array_equal(disp[i].numpy(), jd)
        jz = jxyz[..., 2]
        np.testing.assert_array_equal(np.isfinite(z[i].numpy()),
                                      np.isfinite(jz))
        fin = np.isfinite(jz)
        np.testing.assert_allclose(z[i].numpy()[fin], jz[fin], rtol=RTOL)


def test_bench_full_pipeline_matches_jax(small, inputs):
    rig, lefts, rights = inputs
    run = bench.bench_full_pipeline(rig, lefts, rights, iters=1,
                                    device="cpu")
    assert run.fps > 0 and run.first_s > 0
    cfg = JaxConfig(sgbm=JaxParams(num_disparities=D, block_size=5,
                                   speckle_window_size=200, speckle_range=2),
                    downscale=1, use_wls=True, lr_mode="right_matcher")
    jrig = JaxRig.synthetic(width=W, height=H)
    np.testing.assert_array_equal(rig.Q, jrig.Q)
    want = JaxPipeline(jrig, cfg, rectify=True)._forward_batch(
        jnp.asarray(lefts, jnp.float32), jnp.asarray(rights, jnp.float32))
    np.testing.assert_allclose(run.first["disparity"].numpy(),
                               np.asarray(want["disparity"]),
                               rtol=WLS_RTOL, atol=WLS_ATOL)


def test_bench_sweep_matches_jnp(small, jax_forward):
    """The sweep at a cut shape (48x96x16): the jnp matcher with LR and
    speckle 200/2 on bench.py's arrays, bitwise."""
    jfwd, _ = jax_forward
    run = bench.bench_sweep(iters=1, device="cpu")
    assert run.fps > 0 and run.first.shape == (1, H, W)
    left, right = bench.sweep_inputs(H, W)
    jd = np.asarray(jfwd(left, right)[0])
    np.testing.assert_array_equal(run.first[0].numpy(), jd)


def test_bench_opencv_runs_one_frame(small, capsys, inputs):
    pytest.importorskip("cv2")
    _, lefts, rights = inputs
    fps = bench.bench_opencv(lefts, rights, frames=1, trials=1)
    assert fps > 0
    err = capsys.readouterr().err
    assert "threads" in err and "host CPU" in err


@pytest.mark.parametrize("state,want", [
    ("not built", "kernels built by nvcc and loaded"),
    ("built", "kernels loaded, already built"),
    ("loaded", "kernels already loaded")])
def test_first_call_names_what_it_includes(monkeypatch, tmp_path, state,
                                           want):
    """compile_s's log line says whether the first call built the kernels:
    kernels.status() follows the build directory and the loaded library."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_lib", None)
    if state != "not built":
        kernels.library_path().write_bytes(b"")
    if state == "loaded":
        monkeypatch.setattr(kernels, "_lib", object())
    assert kernels.status() == state
    assert bench._kernel_state(torch.device("cuda")) == want
    assert bench._kernel_state(torch.device("cpu")) == \
        "plain versions on the CPU"


def test_entry_main_prints_ok(monkeypatch, capsys):
    orig = entry._flagship
    monkeypatch.setattr(entry, "_flagship",
                        lambda device: orig(H, W, D, device=device))
    assert entry.main(["cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"entry() ok on cpu: disparity ({H}, {W}), xyz "
                          f"({H}, {W}, 3), valid frac ")


def test_entry_reexports_dryrun_multichip():
    assert entry.dryrun_multichip is dryrun.dryrun_multichip


def test_entry_points_refuse_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (entry.entry, entry.entry_full_pipeline):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
