"""Calibration: the stereo rig and its OpenCV YAML I/O."""

from .config import StereoRig, load_opencv_yaml, save_opencv_yaml  # noqa: F401
