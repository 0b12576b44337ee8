"""Packaging rules of the port: no JAX and nothing of the JAX package is
imported, the port's copies of the framework-free modules agree with their
sources, no silent move to the CPU, and every configuration of the
pipeline builds and runs."""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch import pipeline as tp

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "stereo_depth_ruler_tpu_torch"
MODULES = ["stereo_depth_ruler_tpu_torch",
           "stereo_depth_ruler_tpu_torch.metrics",
           "stereo_depth_ruler_tpu_torch.pipeline",
           "stereo_depth_ruler_tpu_torch.cli",
           "stereo_depth_ruler_tpu_torch.bench",
           "stereo_depth_ruler_tpu_torch.entry",
           "stereo_depth_ruler_tpu_torch.cloud",
           "stereo_depth_ruler_tpu_torch.measure",
           "stereo_depth_ruler_tpu_torch.viz",
           "stereo_depth_ruler_tpu_torch.viewer",
           "stereo_depth_ruler_tpu_torch.calib.config",
           "stereo_depth_ruler_tpu_torch.calib.calibrate",
           "stereo_depth_ruler_tpu_torch.io.synthetic",
           "stereo_depth_ruler_tpu_torch.io.pcd",
           "stereo_depth_ruler_tpu_torch.io.video",
           "stereo_depth_ruler_tpu_torch.ops.voxel",
           "stereo_depth_ruler_tpu_torch.utils.native",
           "stereo_depth_ruler_tpu_torch.utils.capture",
           "stereo_depth_ruler_tpu_torch.ops.sgbm",
           "stereo_depth_ruler_tpu_torch.ops.sgbm_ref",
           "stereo_depth_ruler_tpu_torch.ops.sgbm_cuda",
           "stereo_depth_ruler_tpu_torch.ops.sort",
           "stereo_depth_ruler_tpu_torch.ops.sort_cuda",
           "stereo_depth_ruler_tpu_torch.ops.wls",
           "stereo_depth_ruler_tpu_torch.ops.wls_cuda",
           "stereo_depth_ruler_tpu_torch.ops.remap",
           "stereo_depth_ruler_tpu_torch.ops.reproject",
           "stereo_depth_ruler_tpu_torch.utils.kernels",
           "stereo_depth_ruler_tpu_torch.utils.profiling",
           "stereo_depth_ruler_tpu_torch.parallel",
           "stereo_depth_ruler_tpu_torch.parallel.mesh",
           "stereo_depth_ruler_tpu_torch.parallel.sharded",
           "stereo_depth_ruler_tpu_torch.parallel.dryrun",
           # the cases the spawned processes of tests/test_torch_parallel.py
           # import (tests/ is on the path)
           "torch_parallel_cases"]
SLICE = SGBMParams(num_disparities=16, speckle_window_size=0)


def test_every_module_imports_without_jax():
    code = (f"import sys\nsys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print(sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'stereo_depth_ruler_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path):
    """Top-level package of every import in a file (relative imports are
    the port's own and are skipped)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tests/test_torch_cuda.py",
       "tools/profile_stages_torch.py", "tools/pair_tile_ab.py",
       "tools/speckle_tile_ab.py", "tools/speckle_probe.py",
       "tools/sorted_runs_probe.py", "tools/path_digest.py",
       "tools/mae_torch.py", "tests/torch_parallel_cases.py"]))
def test_no_jax_package_import(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "stereo_depth_ruler_tpu"}, roots


def test_mesh_names_match_the_jax_package():
    """The mesh's axis names and the launcher's environment variables are
    the JAX package's."""
    from stereo_depth_ruler_tpu.parallel import mesh as jmesh
    from stereo_depth_ruler_tpu_torch.parallel import mesh as tmesh
    for name in ("FRAME_AXIS", "TILE_AXIS", "DISP_AXIS"):
        assert getattr(tmesh, name) == getattr(jmesh, name)
    src = (ROOT / "stereo_depth_ruler_tpu" / "parallel" / "mesh.py").read_text()
    mine = (PORT / "parallel" / "mesh.py").read_text()
    env = set(re.findall(r"SDR_[A-Z_]+", src))
    assert env == {"SDR_COORDINATOR", "SDR_NUM_PROCESSES", "SDR_PROCESS_ID"}
    assert set(re.findall(r"SDR_[A-Z_]+", mine)) == env


def test_copied_sgbm_params_match():
    from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
    for kw in ({}, dict(num_disparities=48, block_size=7, p1=100, p2=900,
                        num_paths=4), dict(num_paths=2)):
        mine, ref = SGBMParams(**kw), JaxParams(**kw)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.P1, mine.P2) == (ref.P1, ref.P2)
        assert list(mine.path_dirs) == list(ref.path_dirs)


def test_copied_rig_and_scene_match():
    from stereo_depth_ruler_tpu.calib.config import StereoRig as JaxRig
    from stereo_depth_ruler_tpu.io import synthetic as jsyn
    from stereo_depth_ruler_tpu.ops.remap import build_remap_grids as jgrids
    from stereo_depth_ruler_tpu_torch.io import synthetic as tsyn
    from stereo_depth_ruler_tpu_torch.ops.remap import build_remap_grids
    kw = dict(width=64, height=40, focal=70.0, baseline_mm=45.0)
    mine, ref = StereoRig.synthetic(**kw), JaxRig.synthetic(**kw)
    np.testing.assert_array_equal(mine.Q, ref.Q)
    for g, jg in zip(build_remap_grids(mine, "cpu"), jgrids(ref)):
        np.testing.assert_array_equal(g.idx00.numpy(), np.asarray(jg.idx00))
        np.testing.assert_array_equal(g.wx.numpy(), np.asarray(jg.wx))
        np.testing.assert_array_equal(g.wy.numpy(), np.asarray(jg.wy))
    a = tsyn.render_stereo_pair(tsyn.make_scene(mine, n_boxes=3, seed=6),
                                seed=6, shift=(1.5, 0.0))
    b = jsyn.render_stereo_pair(jsyn.make_scene(ref, n_boxes=3, seed=6),
                                seed=6, shift=(1.5, 0.0))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# module of the JAX package -> its counterpart in the port, where the name
# differs; utils/cache.py, JAX's persistent compile cache, has none
COUNTERPARTS = {"ops/sgbm_pallas.py": "ops/sgbm_cuda.py",
                "ops/sort_tpu.py": "ops/sort_cuda.py",
                "ops/wls_pallas.py": "ops/wls_cuda.py",
                "utils/cache.py": None}


def test_every_jax_module_has_a_counterpart():
    jax_pkg = ROOT / "stereo_depth_ruler_tpu"
    missing = []
    for p in sorted(jax_pkg.rglob("*.py")):
        rel = p.relative_to(jax_pkg).as_posix()
        mine = COUNTERPARTS.get(rel, rel)
        if mine is not None and not (PORT / mine).is_file():
            missing.append(rel)
    assert not missing, missing
    assert not (PORT / "utils" / "cache.py").exists()


# copies of the JAX package's framework-free modules: every line after the
# first (the note naming the source) is the source's
VERBATIM = ["io/pcd.py", "utils/native.py", "measure.py", "viz.py",
            "viewer.py", "calib/calibrate.py"]
# partial copies: every top-level function and class is the source's, but
# for the ones the port rewrites
PARTIAL = {"metrics.py": {"batch_frame_stats"},
           "io/video.py": {"host_batches"},
           "utils/capture.py": {"image_disparity"}}
# names of a partially copied module that the port drops
DROPPED = {"metrics.py": {"StageTimer"}}


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_their_sources(rel):
    first, body = (PORT / rel).read_text().split("\n", 1)
    assert first == (f"# Copy of stereo_depth_ruler_tpu/{rel}: the port "
                     "keeps its own, framework-free.")
    assert body == (ROOT / "stereo_depth_ruler_tpu" / rel).read_text()


def _top_level(path):
    text = path.read_text()
    return {n.name: ast.get_source_segment(text, n)
            for n in ast.parse(text).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("rel", sorted(PARTIAL))
def test_partial_copies_match_their_sources(rel):
    mine = _top_level(PORT / rel)
    src = _top_level(ROOT / "stereo_depth_ruler_tpu" / rel)
    dropped = DROPPED.get(rel, set())
    assert dropped <= src.keys()
    assert mine.keys() == src.keys() - dropped
    for name in src.keys() - PARTIAL[rel] - dropped:
        assert mine[name] == src[name], name
    for name in PARTIAL[rel]:
        assert mine[name] != src[name], name


def test_native_library_path_is_the_repos():
    from stereo_depth_ruler_tpu_torch.utils import native
    assert native._LIB_PATH == ROOT / "native" / "libsdrhost.so"


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rig = StereoRig.synthetic(width=32, height=24)
    cfg = tp.PipelineConfig(sgbm=SLICE, use_wls=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.StereoPipeline(rig, cfg, device="cuda")


@pytest.mark.parametrize("cfg", [
    dict(sgbm=SLICE),                               # right matcher + WLS
    dict(sgbm=SLICE, pair_mode="shared"),           # the shared-cost pair
    dict(sgbm=SGBMParams(num_disparities=16), use_wls=False),   # speckle
], ids=["cfg0-None", "cfg1-pair_mode", "cfg2-None"])
def test_unported_configurations_raise(cfg):
    """No configuration is left unported: the stacked and the shared pair
    with WLS and the speckle configuration build and run on the CPU at
    24x32, and an unknown pair mode is refused."""
    rig = StereoRig.synthetic(width=32, height=24)
    config = tp.PipelineConfig(downscale=1, **cfg)
    with pytest.raises(ValueError, match="pair_mode"):
        tp.StereoPipeline(rig, dataclasses.replace(config, pair_mode="both"),
                          device="cpu")
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (1, 24, 32)).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    out = tp.StereoPipeline(rig, config, device="cpu").process_batch(left,
                                                                      right)
    assert out["disparity"].shape == (1, 24, 32)
    assert torch.isfinite(out["disparity"]).all()


def test_kernel_sources_are_packaged():
    from stereo_depth_ruler_tpu_torch.utils import kernels
    names = sorted(p.name for p in kernels.CSRC_DIR.glob("*.cu"))
    assert names == ["cost_box.cu", "cost_down.cu", "fgs_pass.cu",
                     "radix_sort.cu", "sgm_pass.cu", "shift_gather.cu",
                     "sorted_runs.cu", "speckle.cu", "sweep.cu",
                     "tile_sgm.cu", "transpose.cu", "wta_lr.cu"]
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
