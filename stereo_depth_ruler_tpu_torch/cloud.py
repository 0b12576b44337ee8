"""Colored point-cloud generation path.

Port of ``stereo_depth_ruler_tpu/cloud.py`` (the reference's
``point_cloud`` binary, point_cloud/src/pcd_write.cpp:53-155): disparity
-> reprojectImageTo3D (handleMissingValues=true) -> colorize from the left
image -> VoxelGrid downsample -> binary PCD per frame. On a CUDA device
the matcher is ``sgbm_cuda`` on a one-frame batch (the cost, SGM pass,
WTA/LR and speckle kernels); reprojection, the keep mask and the voxel
reduction run on the device in PyTorch; only the [:count] slice and the
file write happen on the host. On the CPU the same code runs the plain
versions. A device named ``"cuda"`` on a machine without CUDA raises.

As in the JAX package, the reference's cloud path runs its own
full-resolution matcher with no rectification and no WLS, and the default
leaf is the documented 5 mm (0.005 reproduces the reference's unit
quirk, ops/voxel.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .calib.config import StereoRig
from .io.pcd import write_pcd
from .ops.reproject import reproject_to_3d
from .ops.sgbm_cuda import sgbm_cuda
from .ops.sgbm_ref import SGBMParams
from .ops.voxel import voxel_downsample
from .pipeline import _resolve_device, bgr_to_gray

__all__ = ["CloudConfig", "PointCloudGenerator"]


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    """The JAX package's CloudConfig, field for field. ``matcher`` chooses
    among the JAX package's matchers; the port chooses by device (kernels
    on CUDA, plain versions on the CPU), so it takes only ``"auto"``."""
    sgbm: SGBMParams = SGBMParams()
    leaf: float = 5.0                # mm; 0.005 replicates the quirk
    z_clip_mm: float = 10000.0       # drop points at/behind missing-Z fill
    reference_mode: bool = True      # raw full-res SGBM like pcd_write.cpp
    binary: bool = True
    organized: bool = False          # write the pre-voxel organized cloud
    matcher: str = "auto"            # "auto" | "pallas" | "jnp"


class PointCloudGenerator:
    """Builds colored, voxel-downsampled clouds from stereo frames."""

    def __init__(self, rig: StereoRig, config: CloudConfig = CloudConfig(),
                 device="cuda"):
        if config.matcher != "auto":
            raise ValueError(
                f"CloudConfig.matcher must be 'auto' in the port (the "
                f"matcher follows the device), got {config.matcher!r}")
        self.rig = rig
        self.config = config
        self.device = _resolve_device(device)

    def disparity(self, left: torch.Tensor, right: torch.Tensor
                  ) -> torch.Tensor:
        """(H, W) float32 pair on the device -> (H, W) disparity."""
        return sgbm_cuda(left[None].contiguous(), right[None].contiguous(),
                         self.config.sgbm)[0]

    def kept_points(self, disp: torch.Tensor) -> torch.Tensor:
        """(H, W) disparity -> (H*W, 3) points, NaN where a point is
        invalid or at/behind the missing-Z fill (dropped before the
        voxels)."""
        cfg = self.config
        pts = reproject_to_3d(disp, self.rig.Q, handle_missing=True,
                              missing_z=cfg.z_clip_mm).reshape(-1, 3)
        keep = (torch.isfinite(pts).all(dim=1)
                & (pts[:, 2] > 0) & (pts[:, 2] < cfg.z_clip_mm))
        return torch.where(keep[:, None], pts,
                           torch.full_like(pts, float("nan")))

    def cloud_from_pair(self, left: np.ndarray, right: np.ndarray,
                        left_color: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
        """left/right grayscale (H, W); left_color optional (H, W, 3) BGR
        (the reference colors points from the left BGR image,
        pcd_write.cpp:35-44). Returns dict with points/colors/count/disp."""
        if left_color is None:
            left_color = np.repeat(np.asarray(left)[..., None], 3, axis=2)
        # BGR -> RGB for PCD packing
        rgb = np.ascontiguousarray(np.asarray(left_color)[..., ::-1])
        dev = self.device
        disp = self.disparity(
            torch.from_numpy(np.array(left, np.float32)).to(dev),
            torch.from_numpy(np.array(right, np.float32)).to(dev))
        pts = self.kept_points(disp)
        cols = torch.from_numpy(rgb.reshape(-1, 3)).to(dev).to(torch.float32)
        vpts, vcols, count = voxel_downsample(pts, cols, self.config.leaf)
        count = int(count)
        out = {
            "disparity": disp.cpu().numpy(),
            "points": vpts[:count].cpu().numpy(),
            "colors": np.clip(vcols[:count].cpu().numpy(), 0, 255
                              ).astype(np.uint8),
            "count": count,
        }
        if self.config.organized:
            # pre-voxel organized cloud (convertCVMatToPCL parity:
            # width x height, invalid -> NaN, pcd_write.cpp:17-51)
            out["organized_points"] = pts.cpu().numpy()
            out["organized_colors"] = np.clip(
                rgb.reshape(-1, 3), 0, 255).astype(np.uint8)
            out["organized_shape"] = tuple(disp.shape)
        return out

    def write_frame(self, out_dir, frame_index: int, left, right,
                    left_color=None) -> Path:
        """Full reference flow for one frame -> results/frame_%05d.pcd
        naming (pcd_write.cpp:141)."""
        out = self.cloud_from_pair(left, right, left_color)
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"frame_{frame_index:05d}.pcd"
        if self.config.organized:
            write_pcd(path, out["organized_points"],
                      out["organized_colors"], binary=self.config.binary,
                      organized_shape=out["organized_shape"])
        else:
            write_pcd(path, out["points"], out["colors"],
                      binary=self.config.binary)
        return path

    def process_sbs_video(self, frames: np.ndarray, out_dir,
                          target_frames=None) -> list:
        """Side-by-side frames (N, H, 2W[,3]) -> one PCD per selected
        frame (the reference exports frame 100 of cam.mp4,
        pcd_write.cpp:54-57)."""
        w = self.rig.width
        paths = []
        idxs = range(len(frames)) if target_frames is None else target_frames
        for i in idxs:
            f = frames[i]
            if f.ndim == 3:
                # OpenCV BGR weights, like every other ingest path
                # (pipeline.bgr_to_gray, io/video._convert; reference
                # cvtColor at pcd_write.cpp:87-89) — a plain channel
                # mean silently diverges the matcher's input
                gray = bgr_to_gray(torch.from_numpy(
                    np.array(f, np.float32)).to(self.device)).cpu().numpy()
                color_l = f[:, :w]
            else:
                gray = f
                color_l = None
            paths.append(self.write_frame(out_dir, i, gray[:, :w],
                                          gray[:, w:2 * w], color_l))
        return paths
