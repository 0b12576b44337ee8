"""The benchmark's inputs, made from the seed: the rig's matrices and a pool
of stereo pairs rendered on the device.

The scene follows stereo_depth_ruler_tpu_torch/io/synthetic.py's
make_scene / render_stereo_pair, transcribed to PyTorch and frozen here:
a band-limited noise background at one depth and textured boxes at random
depths, composited far to near, the right view shifted by each layer's
disparity. Three-channel frames draw each channel's texture from its own
noise, so the B, G and R planes differ. The frames leave the device as
host uint8 arrays, which is what users hand the pipeline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rig(spec: dict) -> dict:
    """The configuration's ``rig`` block -> the matrices of a rig whose
    cameras share one rotation: raw intrinsics K with Brown-Conrady
    distortion, rectification R1 = R2 = I, rectified projections P1, P2 and
    the reprojection Q at the rectified focal, centre and baseline."""
    f, cx, cy = spec["rect_focal"], spec["rect_cx"], spec["rect_cy"]
    B = spec["baseline_mm"]
    K = np.array([[spec["fx"], 0.0, spec["cx"]], [0.0, spec["fy"], spec["cy"]],
                  [0.0, 0.0, 1.0]])
    dist = np.asarray(spec["dist"], np.float64).reshape(1, 5)
    P1 = np.array([[f, 0.0, cx, 0.0], [0.0, f, cy, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P2 = P1.copy()
    P2[0, 3] = -f * B
    Q = np.array([[1.0, 0, 0, -cx], [0, 1.0, 0, -cy], [0, 0, 0, f],
                  [0, 0, 1.0 / B, 0]])
    eye = np.eye(3)
    return {"width": int(spec["width"]), "height": int(spec["height"]),
            "K1": K, "dist1": dist, "K2": K.copy(), "dist2": dist.copy(),
            "R": eye, "T": np.array([[-B], [0.0], [0.0]]),
            "R1": eye, "R2": eye.copy(), "P1": P1, "P2": P2, "Q": Q}


def _noise(gen, c: int, h: int, w: int, scale: int, dev) -> torch.Tensor:
    """(c, h, w) band-limited texture in [0, 255]: a bilinearly upsampled
    coarse grid plus fine grain."""
    coarse = torch.rand((c, h // scale + 2, w // scale + 2), generator=gen,
                        device=dev) * 255
    ys = torch.linspace(0, coarse.shape[1] - 1.001, h, device=dev)
    xs = torch.linspace(0, coarse.shape[2] - 1.001, w, device=dev)
    yi, xi = ys.floor().long(), xs.floor().long()
    yf, xf = (ys - yi)[:, None], (xs - xi)[None, :]
    r0, r1 = coarse[:, yi], coarse[:, yi + 1]
    img = (r0[:, :, xi] * (1 - yf) * (1 - xf) + r0[:, :, xi + 1] * (1 - yf) * xf
           + r1[:, :, xi] * yf * (1 - xf) + r1[:, :, xi + 1] * yf * xf)
    fine = torch.rand((c, h, w), generator=gen, device=dev) * 255
    return 0.7 * img + 0.3 * fine


def _shift(img: torch.Tensor, d: float) -> torch.Tensor:
    """The view of a layer at disparity d: texture at x + d, linear."""
    w = img.shape[-1]
    xs = torch.arange(w, device=img.device, dtype=torch.float32) + d
    x0 = xs.floor()
    f = xs - x0
    x0 = x0.long()
    return (img[..., x0.clamp(0, w - 1)] * (1 - f)
            + img[..., (x0 + 1).clamp(0, w - 1)] * f)


def _boxes(rng: np.random.Generator, w: int, h: int, n: int,
           z_range) -> list:
    boxes = []
    for _ in range(n):
        bw = int(rng.integers(w // 8, w // 3))
        bh = int(rng.integers(h // 8, h // 3))
        x0 = int(rng.integers(w // 6, w - bw - 1))
        y0 = int(rng.integers(1, h - bh - 1))
        boxes.append((x0, y0, bw, bh, float(rng.uniform(*z_range))))
    return sorted(boxes, key=lambda b: -b[4])   # far to near


def _render(gen, rng, w: int, h: int, c: int, focal_base: float,
            scene: dict, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    tex = _noise(gen, c, h, w + 256, 5, dev)
    left = tex[..., 128:128 + w]
    right = _shift(tex, focal_base / scene["background_z_mm"])[..., 128:128 + w]
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    for k, (bx0, by0, bw, bh, z) in enumerate(
            _boxes(rng, w, h, scene["n_boxes"], scene["z_range_mm"])):
        t = _noise(gen, c, bh, bw + 64, 3, dev)
        views = []
        for img, off in ((left, 0.0), (right, focal_base / z)):
            u = xs - (bx0 - off)
            v = ys - by0
            mask = (((v >= 0) & (v <= bh - 1))[:, None]
                    & ((u >= 0) & (u <= bw - 1))[None, :])
            uc, vc = u.clamp(0, bw - 1.001), v.clamp(0, bh - 1.001)
            u0, v0 = uc.floor().long(), vc.floor().long()
            uf, vf = (uc - u0)[None, :], (vc - v0)[:, None]
            t0, t1 = t[:, v0], t[:, v0 + 1]
            patch = (t0[:, :, u0] * (1 - vf) * (1 - uf)
                     + t0[:, :, u0 + 1] * (1 - vf) * uf
                     + t1[:, :, u0] * vf * (1 - uf)
                     + t1[:, :, u0 + 1] * vf * uf)
            views.append(torch.where(mask, patch, img))
        left, right = views
    return left, right


def pool(rig_m: dict, spec: dict, n: int, seed: int, device
         ) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` pairs of host uint8 frames, (n, H, W) gray or (n, H, W, 3) BGR
    as the configuration's ``input`` block says, each pair its own scene,
    all from ``seed``."""
    w, h = rig_m["width"], rig_m["height"]
    c = 3 if spec["input"]["color"] == "bgr" else 1
    focal_base = rig_m["P1"][0, 0] * float(np.linalg.norm(rig_m["T"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    rng = np.random.default_rng(seed)
    out_l = torch.empty((n, c, h, w), dtype=torch.uint8, device=device)
    out_r = torch.empty_like(out_l)
    for i in range(n):
        left, right = _render(gen, rng, w, h, c, focal_base, spec["scene"],
                              device)
        out_l[i] = left.clamp(0, 255).to(torch.uint8)
        out_r[i] = right.clamp(0, 255).to(torch.uint8)
    if c == 1:
        return out_l[:, 0].cpu().numpy(), out_r[:, 0].cpu().numpy()
    return (out_l.permute(0, 2, 3, 1).contiguous().cpu().numpy(),
            out_r.permute(0, 2, 3, 1).contiguous().cpu().numpy())
