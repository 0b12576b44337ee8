"""Entry points of the port: the flagship forward and the full
pipeline's, each with its example pair, and the multi-process dry run.

Port of ``__graft_entry__.py``:

- ``entry()`` returns (fn, example_args): the flagship forward, the
  full-resolution stereo step (SGBM at 1280x720 x 128 disparities with the
  LR check and speckle 200/2, then the Q reprojection), BASELINE.json's
  headline configuration;
- ``entry_full_pipeline()`` the same for the reference's complete step:
  rectify -> SGBM x2 (right matcher) -> WLS -> reproject
  (stereo_disparity.cpp:17-39);
- ``dryrun_multichip(n)`` the full sharded step on an n-rank mesh
  (``parallel/dryrun.py``).

On CUDA tensors the forwards launch the kernels of ``ops/sgbm_cuda.py``
and ``ops/wls_cuda.py``; with ``device="cpu"`` their plain versions run.
A CUDA device without CUDA raises.

    python -m stereo_depth_ruler_tpu_torch.entry [cpu]

runs ``entry()`` once (on the card unless ``cpu`` is given).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .calib.config import StereoRig
from .ops.reproject import reproject_to_3d
from .ops.sgbm_cuda import sgbm_cuda
from .ops.sgbm_ref import SGBMParams
from .parallel.dryrun import dryrun_multichip
from .pipeline import PipelineConfig, StereoPipeline, _resolve_device

__all__ = ["flagship_params", "full_pipeline", "entry",
           "entry_full_pipeline", "dryrun_multichip"]


def flagship_params(num_disp: int = 128) -> SGBMParams:
    """The headline matcher: 5x5 blocks, speckle 200/2."""
    return SGBMParams(num_disparities=num_disp, block_size=5,
                      speckle_window_size=200, speckle_range=2)


def full_pipeline(rig: StereoRig, params: SGBMParams,
                  device="cuda") -> StereoPipeline:
    """The reference's complete step at full resolution: rectify, the left
    and the right matcher, WLS, reproject."""
    return StereoPipeline(rig, PipelineConfig(
        sgbm=params, downscale=1, use_wls=True, lr_mode="right_matcher"),
        rectify=True, device=device)


def _example_pair(height: int, width: int, device: torch.device):
    """The uniform random float32 pair of ``__graft_entry__.py``, seed 0."""
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (height, width)).astype(np.float32)
    right = rng.uniform(0, 255, (height, width)).astype(np.float32)
    return (torch.from_numpy(left).to(device),
            torch.from_numpy(right).to(device))


def _flagship(height=720, width=1280, num_disp=128, device="cuda"):
    """(forward, rig, params): forward(left, right) takes an (H, W) pair,
    moves it to ``device`` as float32, and returns the disparity (H, W)
    (invalid -1.0) and xyz (H, W, 3)."""
    dev = _resolve_device(device)
    rig = StereoRig.synthetic(width=width, height=height)
    params = flagship_params(num_disp)
    Q = rig.Q

    def forward(left, right):
        left = torch.as_tensor(left, dtype=torch.float32, device=dev)
        right = torch.as_tensor(right, dtype=torch.float32, device=dev)
        disp = sgbm_cuda(left[None], right[None], params, apply_lr=True,
                         apply_speckle=True)[0]
        return disp, reproject_to_3d(disp, Q)

    return forward, rig, params


def entry(device="cuda"):
    """(fn, example_args): the flagship forward on one 1280x720 pair."""
    forward, rig, _ = _flagship(device=device)
    return forward, _example_pair(rig.height, rig.width,
                                  _resolve_device(device))


def entry_full_pipeline(device="cuda"):
    """(fn, example_args): ``StereoPipeline.process_pair`` with the full
    configuration on one 1280x720 pair; fn returns the dict of
    ``process_pair`` (xyz as (3, H, W))."""
    rig = StereoRig.synthetic(width=1280, height=720)
    pipe = full_pipeline(rig, flagship_params(), device)
    return pipe.process_pair, _example_pair(720, 1280, pipe.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[0] if argv else "cuda"
    fn, (left, right) = entry(device)
    disp, xyz = fn(left, right)
    valid = float((disp >= 0).float().mean())
    print(f"entry() ok on {device}: disparity {tuple(disp.shape)}, xyz "
          f"{tuple(xyz.shape)}, valid frac {valid:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
