"""Packaging rules of the port: no JAX and nothing of the JAX package is
imported, the port's copies of the framework-free modules agree with their
sources, no silent move to the CPU, and every configuration of the
pipeline builds and runs."""

import ast
import dataclasses
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
           "stereo_depth_ruler_tpu_torch.calib.config",
           "stereo_depth_ruler_tpu_torch.io.synthetic",
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
           "stereo_depth_ruler_tpu_torch.utils.profiling"]
SLICE = SGBMParams(num_disparities=16, speckle_window_size=0)


def test_every_module_imports_without_jax():
    code = ("import sys\n"
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
       "tools/profile_stages_torch.py"]))
def test_no_jax_package_import(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "stereo_depth_ruler_tpu"}, roots


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
                     "transpose.cu", "wta_lr.cu"]
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
