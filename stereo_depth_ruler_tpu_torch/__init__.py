"""stereo_depth_ruler_tpu_torch — the stereo depth engine in PyTorch + CUDA.

Port of the JAX package ``stereo_depth_ruler_tpu`` to PyTorch on an NVIDIA
H100. Plain tensor code is PyTorch; the matcher's kernels are CUDA C++
(``ops/csrc``), built with nvcc on first use. The JAX package stays the
reference; its framework-free modules (calibration, the SGBM parameters and
NumPy oracle, the synthetic scenes) are imported from it, never JAX itself.
"""

__version__ = "0.1.0"

from stereo_depth_ruler_tpu.calib.config import StereoRig  # noqa: F401
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams  # noqa: F401
