"""Synthetic stereo scenes with exact ground-truth disparity."""

from .synthetic import make_scene, render_stereo_pair  # noqa: F401
