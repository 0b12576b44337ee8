"""Undistortion + rectification as precomputed remap grids + gathers.

Port of ``stereo_depth_ruler_tpu/ops/remap.py`` (the reference's
StereoRectifier: cv::initUndistortRectifyMap once, cv::remap INTER_LINEAR
per frame). The map is computed once on the host in NumPy and decomposed
into flat corner indices and bilinear weights; per frame the device does
four gathers and a lerp, in plain torch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..calib.config import StereoRig

__all__ = ["compute_rectify_map", "RemapGrid", "build_remap_grids",
           "remap_bilinear", "rectify_pair"]


def compute_rectify_map(K: np.ndarray, dist: np.ndarray, R: np.ndarray,
                        P: np.ndarray, size: Tuple[int, int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Float remap tables (map_x, map_y), each (H, W) float32, with the math
    of cv::initUndistortRectifyMap (Brown-Conrady k1, k2, p1, p2, k3).

    NumPy copy of ``stereo_depth_ruler_tpu/ops/remap.py:compute_rectify_map``
    (that module imports JAX)."""
    w, h = size
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64).reshape(-1)
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    P = np.asarray(P, np.float64)
    A = P[:3, :3]  # new camera matrix
    iR = np.linalg.inv(A @ np.asarray(R, np.float64))

    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x = X / W
    y = Y / W
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    map_x = (fx * xd + s * yd + cx).astype(np.float32)
    map_y = (fy * yd + cy).astype(np.float32)
    return map_x, map_y


@dataclasses.dataclass(frozen=True)
class RemapGrid:
    """Bilinear remap decomposed for gathers, on one device.

    ``idx00`` is the flat source index of the top-left corner (int64);
    ``wx, wy`` the fractional weights; ``valid`` masks samples whose 2x2
    support lies inside the source (outside -> 0, BORDER_CONSTANT)."""
    idx00: torch.Tensor  # (H, W) int64
    wx: torch.Tensor     # (H, W) float32
    wy: torch.Tensor     # (H, W) float32
    valid: torch.Tensor  # (H, W) bool
    src_shape: Tuple[int, int]

    @classmethod
    def from_arrays(cls, idx00, wx, wy, valid, src_shape: Tuple[int, int],
                    device) -> "RemapGrid":
        """Grid from NumPy arrays laid out as the JAX package's RemapGrid
        fields, so both packages can share one set of tables."""
        def t(a, dtype):
            return torch.tensor(np.asarray(a, dtype), device=device)

        return cls(idx00=t(idx00, np.int64), wx=t(wx, np.float32),
                   wy=t(wy, np.float32), valid=t(valid, bool),
                   src_shape=(int(src_shape[0]), int(src_shape[1])))

    @classmethod
    def from_maps(cls, map_x: np.ndarray, map_y: np.ndarray,
                  src_shape: Tuple[int, int], device) -> "RemapGrid":
        hs, ws = src_shape
        x0 = np.floor(map_x).astype(np.int64)
        y0 = np.floor(map_y).astype(np.int64)
        wx = (map_x - x0).astype(np.float32)
        wy = (map_y - y0).astype(np.float32)
        valid = (x0 >= 0) & (x0 + 1 <= ws - 1) & (y0 >= 0) & (y0 + 1 <= hs - 1)
        x0c = np.clip(x0, 0, ws - 2)
        y0c = np.clip(y0, 0, hs - 2)
        return cls.from_arrays(y0c * ws + x0c, wx, wy, valid, (hs, ws),
                               device)


def build_remap_grids(rig: StereoRig, device) -> Tuple[RemapGrid, RemapGrid]:
    """Left/right rectification grids for a rig."""
    size = rig.image_size
    hs, ws = rig.height, rig.width
    mxl, myl = compute_rectify_map(rig.camera_matrix_left,
                                   rig.dist_coeffs_left, rig.R1, rig.P1, size)
    mxr, myr = compute_rectify_map(rig.camera_matrix_right,
                                   rig.dist_coeffs_right, rig.R2, rig.P2, size)
    return (RemapGrid.from_maps(mxl, myl, (hs, ws), device),
            RemapGrid.from_maps(mxr, myr, (hs, ws), device))


def remap_bilinear(img: torch.Tensor, grid: RemapGrid,
                   precision: str = "f32") -> torch.Tensor:
    """Bilinear remap of ``img`` (..., Hs, Ws) -> (..., H, W) float32;
    out-of-source samples give 0.

    ``precision="u8"`` first rounds (half to even) and clips the source to
    0..255, as the reference's 8-bit frames are; ``"f32"`` samples the
    values as they are. Both take four direct gathers of the flat image:
    the JAX package's packed single gather was a TPU workaround and gives
    the same corners, since idx00 never lies on the last row or column."""
    if precision not in ("f32", "u8"):
        raise ValueError(f"precision must be 'f32' or 'u8', got {precision!r}")
    hs, ws = grid.src_shape
    src = img.to(torch.float32)
    if precision == "u8":
        src = torch.clamp(torch.round(src), 0, 255)
    flat = src.reshape(src.shape[:-2] + (hs * ws,))
    i00 = grid.idx00
    v00 = flat[..., i00]
    v01 = flat[..., i00 + 1]
    v10 = flat[..., i00 + ws]
    v11 = flat[..., i00 + ws + 1]
    wx, wy = grid.wx, grid.wy
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(grid.valid, out, torch.zeros_like(out))


def rectify_pair(left: torch.Tensor, right: torch.Tensor,
                 grid_l: RemapGrid, grid_r: RemapGrid
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """StereoRectifier::rectify: remap both eyes with their grids."""
    return remap_bilinear(left, grid_l), remap_bilinear(right, grid_r)
