"""The plain reference of the whole stereo step, in plain PyTorch.

It imports nothing of the program: every stage is a frozen copy in this
folder (its first line names the original). From the host's uint8 frames
and the rig's matrices it computes what the pipeline returns: the two
rectified eyes, the disparity after the right matcher and the WLS filter,
the LR confidence, the XYZ map and the per-frame stats. The rectification
grids are derived again from the rig.

``dt`` is the precision of the floating-point stages (gray, rectify,
downscale, WLS, reprojection, stats): float32 as configured, bfloat16 for
the control. The matcher is integer arithmetic and stays exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import post, remap, sgbm, wls


def run(lefts: np.ndarray, rights: np.ndarray, rig: dict, config: dict,
        device, dt: torch.dtype = torch.float32, block: int = 2
        ) -> Dict[str, torch.Tensor]:
    """(N, H, W[, 3]) uint8 pairs -> dict of (N, ...) float32 outputs,
    computed ``block`` pairs at a time so that the matcher's volumes fit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid_l, grid_r = remap.grids(rig, device, dt)
    parts = [_block(lefts[i:i + block], rights[i:i + block], grid_l, grid_r,
                    rig, config, device, dt)
             for i in range(0, len(lefts), block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _block(lefts, rights, grid_l, grid_r, rig, config, device, dt):
    pipe, p = config["pipeline"], config["sgbm"]
    left = torch.as_tensor(lefts).to(device).to(dt)
    right = torch.as_tensor(rights).to(device).to(dt)
    if left.dim() == 4:
        left, right = remap.bgr_to_gray(left), remap.bgr_to_gray(right)
    lrect = remap.remap_u8(left, grid_l)
    rrect = remap.remap_u8(right, grid_r)
    left, right = lrect, rrect
    for _ in range(int(np.log2(pipe["downscale"]))):
        left, right = remap.downscale2x(left), remap.downscale2x(right)
    n = left.shape[0]
    lf, rf = left.to(torch.float32), right.to(torch.float32)
    dd = sgbm.sgbm(torch.cat([lf, rf.flip(-1)]), torch.cat([rf, lf.flip(-1)]),
                   p)
    dl, dr = dd[:n], dd[n:].flip(-1)
    del dd
    disp, conf = wls.wls(dl.to(dt), dr.to(dt), left,
                         p["num_disparities"] + p["min_disparity"],
                         config["wls"])
    xyz = post.reproject(disp, rig["Q"], 1.0 / pipe["downscale"])
    stats = post.frame_stats(disp, xyz[..., 2, :, :], p["num_disparities"],
                             pipe["z_max_mm"])
    out = {"left_rectified": lrect, "right_rectified": rrect,
           "disparity": disp, "confidence": conf, "xyz": xyz,
           "frame_stats": stats}
    return {k: v.to(torch.float32) for k, v in out.items()}
