# Copy of stereo_depth_ruler_tpu/calib/config.py: the port keeps its own, framework-free.
"""Stereo calibration data model + OpenCV-style YAML I/O.

TPU-native counterpart of the reference's ``StereoConfiguration``
(reference: stereo_vision/include/stereo_configuration.hpp:6-16,
stereo_vision/src/stereo_configuration.cpp:4-80). The reference stores the
calibration as a ``cv::FileStorage`` YAML file with ``!!opencv-matrix`` typed
nodes; this module parses/emits that exact schema so ``config/stereo.yaml``
round-trips, and exposes the rig as an immutable dataclass of numpy arrays
that the device pipeline turns into constant ``jnp`` arrays.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["StereoRig", "load_opencv_yaml", "save_opencv_yaml"]


# ---------------------------------------------------------------------------
# OpenCV YAML parsing (no PyYAML dependency: cv::FileStorage emits YAML 1.0
# with custom !!opencv-matrix tags, which stock YAML 1.1 parsers reject).
# ---------------------------------------------------------------------------

_MATRIX_RE = re.compile(
    r"^(?P<name>\w+): !!opencv-matrix\s*$"
)


def _parse_scalar(text: str):
    text = text.strip().strip('"')
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def load_opencv_yaml(path) -> dict:
    """Parse an OpenCV ``FileStorage`` YAML file into a dict.

    ``!!opencv-matrix`` nodes become numpy arrays of the declared shape and
    dtype; plain scalars become int/float/str. Only the subset of YAML that
    cv::FileStorage emits is supported (which is all the reference uses:
    stereo_configuration.cpp:49-74).
    """
    raw = Path(path).read_text()
    lines = raw.splitlines()
    out: dict = {}
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        stripped = line.strip()
        if (not stripped or stripped.startswith("%YAML") or stripped == "---"
                or stripped.startswith("#")):
            i += 1
            continue
        m = _MATRIX_RE.match(stripped)
        if m:
            name = m.group("name")
            props: dict = {}
            i += 1
            data_text = ""
            while i < n:
                sub = lines[i]
                if not sub.startswith(" ") and sub.strip():
                    break
                s = sub.strip()
                if s.startswith("rows:"):
                    props["rows"] = int(s.split(":", 1)[1])
                elif s.startswith("cols:"):
                    props["cols"] = int(s.split(":", 1)[1])
                elif s.startswith("dt:"):
                    props["dt"] = s.split(":", 1)[1].strip()
                elif s.startswith("data:"):
                    data_text = s.split(":", 1)[1]
                    # data may continue over subsequent indented lines
                    j = i + 1
                    while j < n and lines[j].startswith("    ") and \
                            not lines[j].strip().endswith("-matrix"):
                        nxt = lines[j].strip()
                        if re.match(r"^\w+:", nxt):
                            break
                        data_text += " " + nxt
                        j += 1
                    i = j - 1
                i += 1
            nums = [float(t) for t in
                    re.findall(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?",
                               data_text)]
            dt = props.get("dt", "d")
            dtype = {"d": np.float64, "f": np.float32, "i": np.int32,
                     "u": np.uint8, "s": np.int16}.get(dt, np.float64)
            arr = np.asarray(nums, dtype=dtype).reshape(
                props["rows"], props["cols"])
            out[name] = arr
            continue
        if ":" in stripped:
            key, val = stripped.split(":", 1)
            out[key.strip()] = _parse_scalar(val)
        i += 1
    return out


def _fmt_float(v: float) -> str:
    """Format a float the way cv::FileStorage does (repr-ish, trailing .)"""
    if v == int(v) and abs(v) < 1e16:
        return f"{v:.0f}."
    return repr(float(v))


def save_opencv_yaml(path, entries: dict) -> None:
    """Write a dict of scalars / numpy arrays as OpenCV FileStorage YAML.

    Arrays are written as ``!!opencv-matrix`` nodes (dt chosen from dtype) so
    OpenCV's C++ ``cv::FileStorage`` and :func:`load_opencv_yaml` can both
    read the result (schema parity with stereo_configuration.cpp:49-74).
    """
    out = ["%YAML:1.0", "---"]
    for name, val in entries.items():
        if isinstance(val, np.ndarray):
            dt = {np.dtype(np.float64): "d", np.dtype(np.float32): "f",
                  np.dtype(np.int32): "i", np.dtype(np.uint8): "u",
                  np.dtype(np.int16): "s"}[val.dtype]
            out.append(f"{name}: !!opencv-matrix")
            out.append(f"   rows: {val.shape[0]}")
            out.append(f"   cols: {val.shape[1] if val.ndim > 1 else 1}")
            out.append(f"   dt: {dt}")
            flat = val.reshape(-1)
            toks = ([_fmt_float(x) for x in flat] if dt in ("d", "f")
                    else [str(int(x)) for x in flat])
            # wrap at ~70 cols like FileStorage, preserving indentation
            wrapped, cur = [], "   data: ["
            for k, tok in enumerate(toks):
                tok = tok + ("," if k < len(toks) - 1 else " ]")
                if len(cur) + len(tok) + 1 > 70:
                    wrapped.append(cur)
                    cur = "       " + tok
                else:
                    cur = cur + " " + tok
            wrapped.append(cur)
            out.extend(wrapped)
        elif isinstance(val, float):
            out.append(f"{name}: {_fmt_float(val)}")
        else:
            out.append(f"{name}: {val}")
    Path(path).write_text("\n".join(out) + "\n")


# ---------------------------------------------------------------------------
# StereoRig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StereoRig:
    """Full stereo-rig calibration (fields mirror the reference's
    ``StereoConfiguration``, stereo_configuration.hpp:7-11).

    All matrices are float64 numpy arrays; ``image_size`` is ``(width,
    height)`` following OpenCV convention.
    """

    image_size: Tuple[int, int]
    camera_matrix_left: np.ndarray   # (3,3)
    dist_coeffs_left: np.ndarray     # (1,5) Brown-Conrady k1 k2 p1 p2 k3
    camera_matrix_right: np.ndarray  # (3,3)
    dist_coeffs_right: np.ndarray    # (1,5)
    R: np.ndarray                    # (3,3) right-wrt-left rotation
    T: np.ndarray                    # (3,1) translation (calibration units)
    R1: np.ndarray                   # (3,3) left rectification rotation
    R2: np.ndarray                   # (3,3) right rectification rotation
    P1: np.ndarray                   # (3,4) left rectified projection
    P2: np.ndarray                   # (3,4) right rectified projection
    Q: np.ndarray                    # (4,4) disparity->depth reprojection
    E: Optional[np.ndarray] = None   # (3,3) essential
    F: Optional[np.ndarray] = None   # (3,3) fundamental

    # -- derived quantities ------------------------------------------------
    @property
    def width(self) -> int:
        return int(self.image_size[0])

    @property
    def height(self) -> int:
        return int(self.image_size[1])

    @property
    def focal_rectified(self) -> float:
        """Rectified focal length in px (P1[0,0]; 669.900 in stereo.yaml)."""
        return float(self.P1[0, 0])

    @property
    def baseline(self) -> float:
        """Stereo baseline in calibration units (norm of T; mm for the
        reference rig: 120.114, stereo.yaml T[0])."""
        return float(np.linalg.norm(self.T))

    def is_valid(self) -> bool:
        """Mirror of StereoConfiguration::isValid (checks the 5 core
        matrices are present/non-empty, stereo_configuration.cpp:77-80)."""
        for m in (self.camera_matrix_left, self.camera_matrix_right,
                  self.R, self.T, self.Q):
            if m is None or np.asarray(m).size == 0:
                return False
        return self.width > 0 and self.height > 0

    # -- I/O ---------------------------------------------------------------
    _YAML_KEYS = {
        "camera_matrix_left": "cameraMatrixLeft",
        "dist_coeffs_left": "distCoeffsLeft",
        "camera_matrix_right": "cameraMatrixRight",
        "dist_coeffs_right": "distCoeffsRight",
        "R": "R", "T": "T", "E": "E", "F": "F",
        "R1": "R1", "R2": "R2", "P1": "P1", "P2": "P2", "Q": "Q",
    }

    @classmethod
    def from_yaml(cls, path) -> "StereoRig":
        """Load from an OpenCV FileStorage YAML (same schema the reference
        reads in StereoConfiguration::loadFromFile,
        stereo_configuration.cpp:4-46)."""
        d = load_opencv_yaml(path)
        w, h = int(d["imageWidth"]), int(d["imageHeight"])
        if w <= 0 or h <= 0:
            raise ValueError(f"invalid image size {w}x{h} in {path}")
        kwargs = {}
        for field, key in cls._YAML_KEYS.items():
            if key in d:
                kwargs[field] = np.asarray(d[key], dtype=np.float64)
            elif field not in ("E", "F"):
                raise ValueError(f"missing matrix '{key}' in {path}")
        return cls(image_size=(w, h), **kwargs)

    def to_yaml(self, path) -> None:
        """Save with the same key set/order the reference writes
        (stereo_configuration.cpp:49-74)."""
        entries: dict = {
            "imageWidth": self.width,
            "imageHeight": self.height,
        }
        for field, key in self._YAML_KEYS.items():
            val = getattr(self, field)
            if val is not None:
                entries[key] = np.asarray(val, dtype=np.float64)
        save_opencv_yaml(path, entries)

    # -- constructors ------------------------------------------------------
    @classmethod
    def synthetic(cls, width: int = 1280, height: int = 720,
                  focal: float = 669.900, baseline_mm: float = 120.114,
                  cx: Optional[float] = None, cy: Optional[float] = None,
                  distortion: bool = False) -> "StereoRig":
        """An ideal (already-rectified) rig, numerically modeled on the
        reference rig in config/stereo.yaml (f=669.900 px, B=120.114 mm).

        Used by the synthetic-scene generator and tests since the demo
        videos are absent from the reference repo (.gitignore:1-5).
        """
        cx = width / 2.0 - 0.5 if cx is None else cx
        cy = height / 2.0 - 0.5 if cy is None else cy
        K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1.0]])
        dist = np.zeros((1, 5))
        if distortion:
            dist = np.array([[-0.16, 0.0075, -1.4e-4, -4.6e-4, 0.015]])
        R = np.eye(3)
        T = np.array([[-baseline_mm], [0.0], [0.0]])
        P1 = np.hstack([K, np.zeros((3, 1))])
        P2 = P1.copy()
        P2[0, 3] = -focal * baseline_mm
        Q = np.array([
            [1.0, 0, 0, -cx],
            [0, 1.0, 0, -cy],
            [0, 0, 0, focal],
            [0, 0, 1.0 / baseline_mm, 0],
        ])
        return cls(
            image_size=(width, height),
            camera_matrix_left=K, dist_coeffs_left=dist,
            camera_matrix_right=K, dist_coeffs_right=dist.copy(),
            R=R, T=T, R1=np.eye(3), R2=np.eye(3), P1=P1, P2=P2, Q=Q,
        )
