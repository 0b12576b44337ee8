"""stereo_depth_ruler_tpu_torch — the stereo depth engine in PyTorch + CUDA.

Port of the JAX package ``stereo_depth_ruler_tpu`` to PyTorch on an NVIDIA
H100. Plain tensor code is PyTorch; the kernels are CUDA C++
(``ops/csrc``), built with nvcc on first use. The JAX package stays the
reference, and the port imports nothing of it: the framework-free modules
it needs (calibration, the SGBM parameters and NumPy oracle, the synthetic
scenes) are copies kept in this package.
"""

__version__ = "0.2.0"

from .calib.config import StereoRig  # noqa: F401
from .ops.sgbm_ref import SGBMParams  # noqa: F401
