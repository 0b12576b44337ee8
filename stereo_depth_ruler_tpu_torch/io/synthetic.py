# Copy of stereo_depth_ruler_tpu/io/synthetic.py: the port keeps its own, framework-free.
"""Synthetic stereo scene generation with exact ground-truth disparity.

The reference's demo videos (``assets/output.mp4`` / ``assets/cam.mp4``) are
excluded from its repo (.gitignore:1-5), so every test and benchmark here
renders its own stereo footage. Scenes are layered fronto-parallel planes
(background + textured boxes at different depths) composited back-to-front,
so the right view is an exact integer/fractional shift of each layer and the
ground-truth disparity map (with correct occlusions) is known analytically.

Distances between scene corners are therefore known in millimetres, giving
ground truth for the measurement engine (reference artifact:
results/measurements.csv:2-3).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..calib.config import StereoRig

__all__ = ["Box", "SyntheticScene", "make_scene", "render_stereo_pair",
           "make_sbs_video_frames"]


@dataclasses.dataclass
class Box:
    """A textured fronto-parallel rectangle at constant depth.

    ``x0,y0,x1,y1`` are in *left image* pixel coordinates; ``z_mm`` is depth.
    """
    x0: int
    y0: int
    x1: int
    y1: int
    z_mm: float


@dataclasses.dataclass
class SyntheticScene:
    rig: StereoRig
    background_z_mm: float
    boxes: List[Box]

    def disparity_of(self, z_mm: float) -> float:
        """d = f*B/Z for the rig (rectified geometry)."""
        return self.rig.focal_rectified * self.rig.baseline / z_mm


def _smooth_noise(rng: np.random.Generator, h: int, w: int,
                  scale: int = 4) -> np.ndarray:
    """Band-limited texture in [0,255]: upsampled random grid + fine grain.

    Dense local texture is essential: SGBM cannot match flat regions.
    """
    coarse = rng.uniform(0, 255, size=(h // scale + 2, w // scale + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = (ys - yi)[:, None], (xs - xi)[None, :]
    c00 = coarse[yi][:, xi]
    c01 = coarse[yi][:, xi + 1]
    c10 = coarse[yi + 1][:, xi]
    c11 = coarse[yi + 1][:, xi + 1]
    img = (c00 * (1 - yf) * (1 - xf) + c01 * (1 - yf) * xf
           + c10 * yf * (1 - xf) + c11 * yf * xf)
    img = 0.7 * img + 0.3 * rng.uniform(0, 255, size=(h, w))
    return img


def make_scene(rig: Optional[StereoRig] = None,
               n_boxes: int = 4,
               z_range_mm: Tuple[float, float] = (900.0, 4000.0),
               background_z_mm: float = 6000.0,
               seed: int = 0) -> SyntheticScene:
    """Random scene whose disparities stay within typical SGBM ranges.

    With the reference rig (f=669.9 px, B=120.114 mm) depths of
    0.9 m - 6 m give disparities of ~89 down to ~13 px, inside the
    reference's 80-128 disparity search windows.
    """
    rig = rig or StereoRig.synthetic()
    rng = np.random.default_rng(seed)
    w, h = rig.image_size
    boxes = []
    for _ in range(n_boxes):
        bw = int(rng.integers(w // 8, w // 3))
        bh = int(rng.integers(h // 8, h // 3))
        x0 = int(rng.integers(w // 6, w - bw - 1))
        y0 = int(rng.integers(1, h - bh - 1))
        z = float(rng.uniform(*z_range_mm))
        boxes.append(Box(x0, y0, x0 + bw, y0 + bh, z))
    # nearest boxes drawn last (painter's algorithm: far -> near)
    boxes.sort(key=lambda b: -b.z_mm)
    return SyntheticScene(rig=rig, background_z_mm=background_z_mm,
                          boxes=boxes)


def _shift_right(img: np.ndarray, d: float) -> np.ndarray:
    """Shift an image left by d pixels (content moves -x), linear interp.

    For a fronto-parallel layer at disparity d, the right view sees the
    texture at x_r = x_l - d.
    """
    h, w = img.shape[:2]
    xs = np.arange(w) + d
    x0 = np.floor(xs).astype(int)
    f = xs - x0
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    return img[:, x0c] * (1 - f[None, :]) + img[:, x1c] * f[None, :]


def render_stereo_pair(scene: SyntheticScene, seed: int = 0,
                       shift: Tuple[float, float] = (0.0, 0.0)
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render (left, right, gt_disparity).

    Returns uint8 grayscale left/right images (H, W) and the float32
    ground-truth left-view disparity (H, W); occluded-in-right regions keep
    the disparity of the *visible* (nearest) surface, matching what a stereo
    matcher should ideally output. ``shift`` translates box positions
    (sub-pixel allowed) for animating video sequences.
    """
    rig = scene.rig
    w, h = rig.image_size
    rng = np.random.default_rng(seed + 12345)

    d_bg = scene.disparity_of(scene.background_z_mm)
    tex_bg = _smooth_noise(rng, h, w + 256, scale=5)
    left = tex_bg[:, 128:128 + w].copy()
    right = _shift_right(tex_bg, d_bg)[:, 128:128 + w].copy()
    disp = np.full((h, w), d_bg, np.float32)

    dx, dy = shift
    for k, box in enumerate(scene.boxes):
        d = scene.disparity_of(box.z_mm)
        bx0, by0 = box.x0 + dx, box.y0 + dy
        bw, bh = box.x1 - box.x0, box.y1 - box.y0
        tex = _smooth_noise(np.random.default_rng(seed * 997 + k), bh, bw + 64,
                            scale=3)
        # left view: box occupies [bx0, bx0+bw) x [by0, by0+bh)
        for img, off in ((left, 0.0), (right, d)):
            x_start = bx0 - off
            xs = np.arange(w)
            ys = np.arange(h)
            # texture coords for each target pixel
            u = xs - x_start
            v = ys - by0
            valid_x = (u >= 0) & (u <= bw - 1)
            valid_y = (v >= 0) & (v <= bh - 1)
            if not valid_x.any() or not valid_y.any():
                continue
            u0 = np.floor(np.clip(u, 0, bw - 1.001)).astype(int)
            v0 = np.floor(np.clip(v, 0, bh - 1.001)).astype(int)
            uf = np.clip(u, 0, bw - 1.001) - u0
            vf = np.clip(v, 0, bh - 1.001) - v0
            patch = (tex[v0][:, u0] * (1 - vf[:, None]) * (1 - uf[None, :])
                     + tex[v0][:, u0 + 1] * (1 - vf[:, None]) * uf[None, :]
                     + tex[v0 + 1][:, u0] * vf[:, None] * (1 - uf[None, :])
                     + tex[v0 + 1][:, u0 + 1] * vf[:, None] * uf[None, :])
            mask = valid_y[:, None] & valid_x[None, :]
            img[mask] = patch[mask]
        # ground-truth disparity from the left view
        xs = np.arange(w)
        ys = np.arange(h)
        mx = (xs >= bx0) & (xs <= bx0 + bw - 1)
        my = (ys >= by0) & (ys <= by0 + bh - 1)
        disp[np.ix_(my, mx)] = d

    left = np.clip(left, 0, 255).astype(np.uint8)
    right = np.clip(right, 0, 255).astype(np.uint8)
    return left, right, disp


def make_sbs_video_frames(scene: SyntheticScene, n_frames: int,
                          seed: int = 0,
                          motion_px_per_frame: float = 2.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Render an animated side-by-side sequence.

    Returns (frames, gt_disp): frames is (N, H, 2W) uint8 — the same
    side-by-side layout the reference's videos use (split at W in
    stereo_displayer.cpp:155-156) — and gt_disp is (N, H, W) float32.
    """
    h = scene.rig.height
    w = scene.rig.width
    frames = np.empty((n_frames, h, 2 * w), np.uint8)
    gt = np.empty((n_frames, h, w), np.float32)
    for t in range(n_frames):
        dx = motion_px_per_frame * t
        l, r, d = render_stereo_pair(scene, seed=seed, shift=(dx, 0.0))
        frames[t, :, :w] = l
        frames[t, :, w:] = r
        gt[t] = d
    return frames, gt
