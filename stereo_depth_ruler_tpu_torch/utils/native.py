# Copy of stereo_depth_ruler_tpu/utils/native.py: the port keeps its own, framework-free.
"""ctypes bindings for the native host runtime (native/hostio.cpp).

Every function has a pure-Python fallback (io/pcd.py, ops/voxel.py,
io/video.py); this module is the fast path for host-side I/O — PCD
writing, voxel downsampling for export, and prefetching SBSV reads. Build
with ``make -C native``; absence of the .so is never an error.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "write_pcd_native", "voxel_downsample_native",
           "NativeSbsvReader", "csv_append_native"]

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / \
    "libsdrhost.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.sdr_write_pcd.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.sdr_write_pcd.restype = ctypes.c_int
    lib.sdr_voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.sdr_voxel_downsample.restype = ctypes.c_int64
    lib.sdr_sbsv_open.argtypes = [ctypes.c_char_p]
    lib.sdr_sbsv_open.restype = ctypes.c_void_p
    lib.sdr_sbsv_info.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.sdr_sbsv_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64]
    lib.sdr_sbsv_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p]
    lib.sdr_sbsv_read.restype = ctypes.c_int64
    lib.sdr_sbsv_close.argtypes = [ctypes.c_void_p]
    lib.sdr_csv_append.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
    lib.sdr_csv_append.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_pcd_native(path, xyz: np.ndarray,
                     rgb: Optional[np.ndarray] = None,
                     binary: bool = True) -> bool:
    lib = _load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    rgb_p = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, np.uint8).reshape(-1, 3)
        rgb_p = rgb.ctypes.data_as(ctypes.c_void_p)
    rc = lib.sdr_write_pcd(str(path).encode(), _fptr(xyz), rgb_p,
                           len(xyz), 1 if binary else 0)
    return rc == 0


def voxel_downsample_native(xyz: np.ndarray, rgb: Optional[np.ndarray],
                            leaf: float
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    out_xyz = np.empty((n, 3), np.float32)
    out_rgb = np.empty((n, 3), np.uint8)
    rgb_p = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, np.uint8).reshape(-1, 3)
        rgb_p = rgb.ctypes.data_as(ctypes.c_void_p)
    k = lib.sdr_voxel_downsample(
        _fptr(xyz), rgb_p, n, leaf, _fptr(out_xyz),
        out_rgb.ctypes.data_as(ctypes.c_void_p))
    if k < 0:
        return None
    return out_xyz[:k], (out_rgb[:k] if rgb is not None else None)


class NativeSbsvReader:
    """Prefetching SBSV reader; `read(start, count)` overlaps the next
    block's disk I/O with the caller's compute via `prefetch`."""

    def __init__(self, path):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        self._h = lib.sdr_sbsv_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open {path}")
        info = (ctypes.c_int32 * 4)()
        lib.sdr_sbsv_info(self._h, info)
        self.n, self.height, self.width, self.channels = (
            info[0], info[1], info[2], info[3])

    def prefetch(self, start: int, count: int) -> None:
        self._lib.sdr_sbsv_prefetch(self._h, start, count)

    def read(self, start: int, count: int) -> np.ndarray:
        shape = ((count, self.height, self.width) if self.channels == 1
                 else (count, self.height, self.width, self.channels))
        out = np.empty(shape, np.uint8)
        got = self._lib.sdr_sbsv_read(self._h, start, count,
                                      out.ctypes.data_as(ctypes.c_void_p))
        return out[:got]

    def close(self) -> None:
        if self._h:
            self._lib.sdr_sbsv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def csv_append_native(path, header: str, row: str) -> bool:
    lib = _load()
    if lib is None:
        return False
    return lib.sdr_csv_append(str(path).encode(), header.encode(),
                              row.encode()) == 0
