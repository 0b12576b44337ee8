"""Packaging rules of the port: no JAX import, no silent move to the CPU,
and the configurations that later work brings are rejected."""

import subprocess
import sys
from pathlib import Path

import pytest

import torch

from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch import pipeline as tp

ROOT = Path(__file__).resolve().parent.parent
MODULES = ["stereo_depth_ruler_tpu_torch",
           "stereo_depth_ruler_tpu_torch.metrics",
           "stereo_depth_ruler_tpu_torch.pipeline",
           "stereo_depth_ruler_tpu_torch.ops.sgbm",
           "stereo_depth_ruler_tpu_torch.ops.sgbm_cuda",
           "stereo_depth_ruler_tpu_torch.ops.remap",
           "stereo_depth_ruler_tpu_torch.ops.reproject",
           "stereo_depth_ruler_tpu_torch.utils.kernels"]
SLICE = SGBMParams(num_disparities=16, speckle_window_size=0)


def test_every_module_imports_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "import stereo_depth_ruler_tpu.io.synthetic\n"
            + "print('jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rig = StereoRig.synthetic(width=32, height=24)
    cfg = tp.PipelineConfig(sgbm=SLICE, use_wls=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.StereoPipeline(rig, cfg, device="cuda")


@pytest.mark.parametrize("cfg,match", [
    (dict(sgbm=SLICE), "WLS"),
    (dict(sgbm=SLICE, use_wls=False, pair_mode="shared"), "pair_mode"),
    (dict(sgbm=SGBMParams(num_disparities=16), use_wls=False), "speckle"),
])
def test_unported_configurations_raise(cfg, match):
    rig = StereoRig.synthetic(width=32, height=24)
    with pytest.raises(NotImplementedError, match=match):
        tp.StereoPipeline(rig, tp.PipelineConfig(**cfg), device="cpu")


def test_kernel_sources_are_packaged():
    from stereo_depth_ruler_tpu_torch.utils import kernels
    names = sorted(p.name for p in kernels.CSRC_DIR.glob("*.cu"))
    assert names == ["cost_box.cu", "sgm_pass.cu", "wta_lr.cu"]
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
