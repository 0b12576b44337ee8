# Copy of stereo_depth_ruler_tpu/io/pcd.py: the port keeps its own, framework-free.
"""PCD (Point Cloud Data) container I/O — pure Python/NumPy.

Counterpart of the reference's PCL export (``pcl::io::savePCDFileBinary``
to ``results/frame_%05d.pcd``, point_cloud/src/pcd_write.cpp:135-146).
Writes PCD v0.7 binary (and ASCII) files with the same XYZRGB layout PCL
uses for ``pcl::PointXYZRGB`` clouds, and reads them back for testing.

PCL's PointXYZRGB memory layout is 32 bytes: float x,y,z, 4 bytes padding,
rgb packed into a float, then 12 bytes padding. The standard *file* schema
(what savePCDFileBinary emits for organized XYZRGB clouds) is
``FIELDS x y z rgb`` with rgb a packed float — reproduced here.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["write_pcd", "read_pcd", "pack_rgb", "unpack_rgb"]


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """(N, 3) uint8-valued RGB -> (N,) float32 with PCL bit packing
    (0x00RRGGBB reinterpreted as float)."""
    rgb = np.asarray(rgb).astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    return packed.view(np.float32)


def unpack_rgb(f: np.ndarray) -> np.ndarray:
    packed = np.asarray(f, np.float32).view(np.uint32)
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return np.stack([r, g, b], axis=1).astype(np.uint8)


def write_pcd(path, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
              binary: bool = True,
              organized_shape: Optional[Tuple[int, int]] = None) -> Path:
    """Write a PCD file.

    xyz: (N, 3) float32 (may contain NaN for invalid points of organized
    clouds); rgb: optional (N, 3) uint8. ``organized_shape=(height,
    width)`` writes an organized cloud (the reference's
    convertCVMatToPCL makes organized clouds, pcd_write.cpp:17-51);
    otherwise an unorganized 1xN cloud.
    """
    path = Path(path)
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    if organized_shape:
        height, width = organized_shape
        assert height * width == n, (organized_shape, n)
    else:
        height, width = 1, n

    has_rgb = rgb is not None
    if has_rgb:
        rgbf = pack_rgb(np.asarray(rgb).reshape(-1, 3))
        fields = "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1"
        data = np.empty((n, 4), np.float32)
        data[:, :3] = xyz
        data[:, 3] = rgbf
    else:
        fields = "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1"
        data = xyz

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"{fields}\n"
        f"WIDTH {width}\n"
        f"HEIGHT {height}\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            for row in data:
                f.write((" ".join(f"{v:.8g}" for v in row) + "\n").encode())
    return path


def read_pcd(path) -> Tuple[np.ndarray, Optional[np.ndarray], Tuple[int, int]]:
    """Read a PCD file written by write_pcd (or PCL, same schema).

    Returns (xyz (N,3) f32, rgb (N,3) u8 or None, (height, width))."""
    raw = Path(path).read_bytes()
    lines = []
    pos = 0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode()
        pos = nl + 1
        lines.append(line)
        if line.startswith("DATA"):
            break
    meta = {}
    for ln in lines:
        if ln.startswith("#"):
            continue
        k, _, v = ln.partition(" ")
        meta[k] = v
    fields = meta["FIELDS"].split()
    n = int(meta["POINTS"])
    width = int(meta["WIDTH"])
    height = int(meta["HEIGHT"])
    ncol = len(fields)
    if meta["DATA"] == "binary":
        data = np.frombuffer(raw[pos:pos + 4 * ncol * n],
                             np.float32).reshape(n, ncol)
    else:
        data = np.loadtxt(raw[pos:].decode().splitlines(),
                          dtype=np.float32).reshape(n, ncol)
    xyz = data[:, :3].copy()
    rgb = unpack_rgb(data[:, 3]) if "rgb" in fields else None
    return xyz, rgb, (height, width)
