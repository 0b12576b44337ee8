"""Voxel-grid downsampling of point clouds on tensors.

Port of ``stereo_depth_ruler_tpu/ops/voxel.py`` (the reference's PCL
``VoxelGrid``, pcd_write.cpp:123-130), the same sort-based segment mean on
fixed shapes:

1. quantize XYZ to int32 voxel coordinates, floor(p * (1 / leaf)) with
   the float32 reciprocal; non-finite points get INT32_MAX on all three
   axes and sort last;
2. sort the points lexicographically by (kx, ky, kz): three stable sorts,
   the last key first;
3. mark where a run of equal keys starts, dense segment ids by a cumsum;
4. ``index_add_`` positions, colours and counts (capacity N);
5. divide -> per-voxel centroids; ``count`` says how many are real.

The voxel order and ``count`` are exact; the centroids and colours agree
with the JAX package's to float tolerance only, since the order of a
segment's float additions differs (``index_add_`` on a CUDA tensor adds
with atomics). The keys multiply by the float32 reciprocal of ``leaf``, as
the JAX function does under ``jit`` (XLA turns its ``p / leaf`` into that
product, and the JAX ``PointCloudGenerator`` is jitted) and as PCL's
``VoxelGrid`` does with its inverse leaf size. A point on a voxel edge can
land in another voxel than the true quotient would put it in; the product
is the same on the CPU and the card, so both key it alike.

``leaf`` is in the cloud's units: the reference's 0.005 on millimetre
clouds downsamples nothing (SURVEY.md §2.7); 5.0 is the documented 5 mm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["voxel_downsample"]

_BIG = torch.iinfo(torch.int32).max


def voxel_downsample(xyz: torch.Tensor, rgb: Optional[torch.Tensor],
                     leaf: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 3) points (+ optional (N, 3) colours) -> voxel centroids.

    Returns (points (N, 3), colours (N, 3) or zeros, count, a 0-dim int64
    tensor), on the device of ``xyz``; entries past ``count`` are zero.
    Centroids are the mean of each occupied voxel's members, in the order
    of their voxel keys."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32)
    n = xyz.shape[0]
    finite = torch.isfinite(xyz).all(dim=1)
    safe = torch.where(finite[:, None], xyz, torch.zeros_like(xyz))
    inv = torch.tensor(np.float32(1) / np.float32(leaf), device=xyz.device)
    coords = torch.floor(safe * inv).to(torch.int32)
    keys = torch.where(finite[:, None], coords,
                       torch.full_like(coords, _BIG))
    order = torch.arange(n, device=xyz.device)
    for axis in (2, 1, 0):
        _, idx = torch.sort(keys[order, axis], stable=True)
        order = order[idx]
    ks = keys[order]
    starts = torch.ones(n, dtype=torch.bool, device=xyz.device)
    starts[1:] = (ks[1:] != ks[:-1]).any(dim=1)
    seg = torch.cumsum(starts, 0) - 1

    ones = finite[order].to(torch.float32)
    counts = torch.zeros(n, dtype=torch.float32, device=xyz.device)
    counts.index_add_(0, seg, ones)
    sums = torch.zeros_like(xyz).index_add_(0, seg,
                                            safe[order] * ones[:, None])
    denom = counts.clamp(min=1.0)[:, None]
    centroids = sums / denom
    if rgb is not None:
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=xyz.device)
        csum = torch.zeros_like(xyz).index_add_(0, seg,
                                                rgb[order] * ones[:, None])
        colors = csum / denom
    else:
        colors = torch.zeros_like(centroids)
    count = (counts > 0).sum()
    return centroids, colors, count
