# Frozen copy of stereo_depth_ruler_tpu_torch/ops/remap.py and the colour/downscale helpers of pipeline.py, with a dtype argument.
"""Rectification from the rig's matrices, gray conversion and the 0.5x
downscale, in plain PyTorch.

The map follows cv::initUndistortRectifyMap (Brown-Conrady k1, k2, p1, p2,
k3) and is sampled as cv::remap INTER_LINEAR with BORDER_CONSTANT: four
gathers and a lerp. ``dt`` is the precision of every floating-point step
(float32 for the reference, bfloat16 for its control); the map itself is
computed in float64 on the host and rounded to float32, as the rig's
tables are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rectify_map(K: np.ndarray, dist: np.ndarray, R: np.ndarray,
                P: np.ndarray, size: Tuple[int, int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(map_x, map_y), each (H, W) float32: the source pixel of every
    rectified pixel."""
    w, h = size
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (list(np.asarray(dist, np.float64).reshape(-1))
                          + [0.0] * 5)[:5]
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3]
                       @ np.asarray(R, np.float64))
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    Wh = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x, y = X / Wh, Y / Wh
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    map_x = (K[0, 0] * xd + K[0, 1] * yd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


class Grid:
    """A bilinear remap as flat corner indices, weights and a mask."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray,
                 src_shape: Tuple[int, int], device, dt: torch.dtype):
        hs, ws = src_shape
        x0 = np.floor(map_x).astype(np.int64)
        y0 = np.floor(map_y).astype(np.int64)
        wx = (map_x - x0).astype(np.float32)
        wy = (map_y - y0).astype(np.float32)
        valid = ((x0 >= 0) & (x0 + 1 <= ws - 1) & (y0 >= 0)
                 & (y0 + 1 <= hs - 1))
        idx = np.clip(y0, 0, hs - 2) * ws + np.clip(x0, 0, ws - 2)
        self.ws = ws
        self.idx00 = torch.tensor(idx, device=device)
        self.wx = torch.tensor(wx, device=device).to(dt)
        self.wy = torch.tensor(wy, device=device).to(dt)
        self.valid = torch.tensor(valid, device=device)


def grids(rig: dict, device, dt: torch.dtype) -> Tuple[Grid, Grid]:
    """The left and right rectification grids of a rig (``inputs.rig``'s
    dict of matrices)."""
    size = (rig["width"], rig["height"])
    src = (rig["height"], rig["width"])
    return tuple(Grid(*rectify_map(rig[f"K{s}"], rig[f"dist{s}"],
                                   rig[f"R{s}"], rig[f"P{s}"], size),
                      src, device, dt) for s in ("1", "2"))


def remap_u8(img: torch.Tensor, grid: Grid) -> torch.Tensor:
    """(..., Hs, Ws) -> (..., H, W) in img's dtype: the source rounded (half
    to even) and clipped to 0..255, then sampled; 0 outside the source."""
    src = torch.clamp(torch.round(img), 0, 255)
    flat = src.reshape(src.shape[:-2] + (-1,))
    i00 = grid.idx00
    v00 = flat[..., i00]
    v01 = flat[..., i00 + 1]
    v10 = flat[..., i00 + grid.ws]
    v11 = flat[..., i00 + grid.ws + 1]
    wx, wy = grid.wx, grid.wy
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(grid.valid, out, torch.zeros_like(out))


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) gray, OpenCV weights."""
    return 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]


def downscale2x(img: torch.Tensor) -> torch.Tensor:
    """INTER_AREA 0.5x: the mean of each 2x2 block."""
    h, w = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
    img = img[..., :h, :w]
    s = tuple(img.shape)
    return img.reshape(s[:-2] + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))
