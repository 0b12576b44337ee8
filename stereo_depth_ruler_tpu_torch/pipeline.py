"""End-to-end stereo depth pipeline: rectify -> SGBM -> WLS -> reproject
-> stats.

Port of ``stereo_depth_ruler_tpu/pipeline.py``. On a CUDA device the
matcher runs the five CUDA kernels of ``ops/sgbm_cuda.py`` (cost, SGM
pass, WTA/LR, speckle labels and keep) and the WLS filter the two of
``ops/wls_cuda.py`` (shift gather, FGS pass); on the CPU they run their
plain versions. A device named ``"cuda"`` on a machine without CUDA raises:
the pipeline never moves to the CPU by itself.

With ``use_wls=True`` and ``lr_mode="right_matcher"`` (the defaults, the
reference's flow) the left and the right matcher run as one matcher call
on the stacked 2N frames, and the WLS filter smooths the left disparity
with the LR confidence. ``pair_mode="shared"`` builds the right matcher's
cost volume from the left one's (``sgbm_pair_cuda``) instead; the two
pair modes give bit-identical maps. The JAX package falls back to the
stacked pair where its kernel's on-chip memory is too small
(8 * D * W > 2^21); the port has no such limit and runs the shared pair at
every width. ``lr_mode="fast"`` is the in-matcher LR check.

While a torch profiler records, each ``process_pair`` / ``process_batch``
call is a ``record_function`` span ``sdr.call`` holding, in order and
apart, ``sdr.upload``, ``sdr.prep`` (gray, rectify, downscale),
``sdr.matcher`` (the pair's stacking and split included), ``sdr.wls``
(with WLS only) and ``sdr.post`` (confidence without WLS, reprojection,
stats); the profiler's trace then puts each device operation, and each
idle gap, under the stage whose host code was running. With no profiler
recording no span is made.

On a CUDA device ``process_pair`` replays a captured CUDA graph of
``_forward`` (``_graph_step`` says when): its caller waits for each pair,
so the host's launches would be on the critical path. A replayed call's
``sdr.call`` holds ``sdr.upload`` (the copies into the graph's inputs)
and no stage span: the host runs no stage's code then.
``process_batch`` stays eager: its callers run a batch ahead, so its
launches hide behind the previous batch's device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .calib.config import StereoRig
from .ops.sgbm_ref import SGBMParams

from .metrics import batch_frame_stats
from .ops.remap import RemapGrid, build_remap_grids, remap_bilinear
from .ops.reproject import reproject_to_3d
from .ops.sgbm_cuda import sgbm_cuda, sgbm_pair_cuda
from .ops.wls_cuda import wls_disparity_filter_cuda

__all__ = ["PipelineConfig", "StereoPipeline", "bgr_to_gray", "downscale2x",
           "GRAPH_CALLS", "reset_graph_counts"]


_OFF = contextlib.nullcontext()

# process_pair calls by how they ran: eagerly, capturing the graph (and
# replaying it once for the call's own outputs), or replaying it. The ops'
# LAUNCHES count the eager calls and the captures, not the replays.
GRAPH_CALLS = {"eager": 0, "captured": 0, "replayed": 0}


def reset_graph_counts() -> None:
    for k in GRAPH_CALLS:
        GRAPH_CALLS[k] = 0


def _graph_step(held, last, sig) -> str:
    """How ``process_pair`` runs a call whose inputs have the signature
    ``sig``, given the signature of the held graph (``held``, None for
    none) and of the previous call (``last``): "replay" the held graph,
    "capture" a new one in its place (the signature's second call in a
    row; the first ran eagerly, which built and loaded what the capture
    needs), or run "eager"."""
    if sig == held:
        return "replay"
    return "capture" if sig == last else "eager"


def _span(name):
    """A profiler span while a torch profiler records, else nothing."""
    return record_function(name) if torch.autograd._profiler_enabled() else _OFF


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) gray, OpenCV weights."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def downscale2x(img: torch.Tensor) -> torch.Tensor:
    """INTER_AREA 0.5x == exact 2x2 mean."""
    h, w = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
    img = img[..., :h, :w]
    s = tuple(img.shape)
    return img.reshape(s[:-2] + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline configuration, the fields and defaults of the JAX package's
    PipelineConfig, so one set of values configures both packages.
    ``matcher`` and ``wls_kernel`` choose among the JAX package's
    implementations; the port chooses by device (kernels on CUDA, plain
    versions on the CPU) and does not read them."""
    sgbm: SGBMParams = SGBMParams()
    downscale: int = 2            # 1 = full res; 2 = reference behavior
    use_wls: bool = True
    lr_mode: str = "right_matcher"  # "right_matcher" | "fast" | "none"
    quirk_compat: bool = False    # full-res Q on half-res disparity
    handle_missing: bool = False
    z_max_mm: float = 12000.0
    matcher: str = "auto"         # "auto" | "pallas" | "jnp"
    pair_mode: str = "stacked"    # "stacked" | "shared"
    wls_kernel: str = "auto"      # "auto" | "pallas" | "jnp"
    with_stats: bool = True       # per-frame stats reduced on the device
    remap_precision: str = "u8"   # "u8" (rounds/clips to 0-255) | "f32"


def _check_supported(cfg: PipelineConfig) -> None:
    if cfg.lr_mode not in ("right_matcher", "fast", "none"):
        raise ValueError(f"unknown lr_mode {cfg.lr_mode!r}")
    if cfg.pair_mode not in ("stacked", "shared"):
        raise ValueError(f"unknown pair_mode {cfg.pair_mode!r}")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be a CPU or CUDA device, got {device!r}")
    return dev


def _log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    if (1 << k) != n:
        raise ValueError(f"downscale must be a power of 2, got {n}")
    return k


class StereoPipeline:
    """Holds the rectification grids on the device and processes frame
    pairs or batches of them.

    ``grids`` = (left, right) RemapGrid takes the place of the grids built
    from ``rig``, e.g. the JAX package's tables carried across with
    ``RemapGrid.from_arrays``.

    On a CUDA device ``process_pair`` holds at most one captured graph,
    with its own memory pool, keyed by the shape and dtype of the two
    inputs alone: the config, the grids and the rig are taken as fixed
    from construction, so a grid swapped after the capture is not seen."""

    def __init__(self, rig: StereoRig, config: PipelineConfig = PipelineConfig(),
                 rectify: bool = True, device="cuda",
                 grids: Optional[Tuple[RemapGrid, RemapGrid]] = None):
        _check_supported(config)
        self.rig = rig
        self.config = config
        self.rectify = rectify
        self.device = _resolve_device(device)
        self._range_warned = False
        self._n_down = _log2(config.downscale)
        if not rectify:
            self.grid_l = self.grid_r = None
        elif grids is not None:
            self.grid_l, self.grid_r = grids
        else:
            self.grid_l, self.grid_r = build_remap_grids(rig, self.device)
        self._graph = None      # (signature, graph, inputs, outputs)
        self._last_sig = None

    def _forward(self, left: torch.Tensor, right: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """(N, H, W[, 3]) pair batch -> dict of (N, ...) tensors."""
        cfg = self.config
        # upload in the input's own dtype (uint8 frames are a quarter of
        # the float32 bytes) and convert on the device: a CPU->CUDA copy
        # that changes dtype converts on the host first
        with _span("sdr.upload"):
            left = left.to(self.device).to(torch.float32)
            right = right.to(self.device).to(torch.float32)
        with _span("sdr.prep"):
            if left.dim() == 4:  # color input
                left = bgr_to_gray(left)
                right = bgr_to_gray(right)
            if self.rectify:
                left = remap_bilinear(left, self.grid_l, cfg.remap_precision)
                right = remap_bilinear(right, self.grid_r,
                                       cfg.remap_precision)
            lrect, rrect = left, right
            for _ in range(self._n_down):
                left = downscale2x(left)
                right = downscale2x(right)
        wls = cfg.use_wls and cfg.lr_mode == "right_matcher"
        if wls:
            with _span("sdr.matcher"):
                if cfg.pair_mode == "shared":
                    disp_l, disp_r = sgbm_pair_cuda(left.contiguous(),
                                                    right.contiguous(),
                                                    cfg.sgbm)
                else:
                    # the left matcher and the right one (the left matcher
                    # on the mirrored, swapped pair) as one call on 2N
                    # frames
                    n = left.shape[0]
                    dd = sgbm_cuda(
                        torch.cat([left, right.flip(-1)]).contiguous(),
                        torch.cat([right, left.flip(-1)]).contiguous(),
                        cfg.sgbm)
                    disp_l, disp_r = dd[:n], dd[n:].flip(-1).contiguous()
            with _span("sdr.wls"):
                D = cfg.sgbm.num_disparities + cfg.sgbm.min_disparity
                disp, conf = wls_disparity_filter_cuda(disp_l, disp_r, left,
                                                       max_disp=D)
        else:
            with _span("sdr.matcher"):
                disp = sgbm_cuda(left.contiguous(), right.contiguous(),
                                 cfg.sgbm, apply_lr=cfg.lr_mode != "none")
        with _span("sdr.post"):
            if not wls:
                conf = (disp >= 0).to(torch.float32)
            xyz = reproject_to_3d(disp, self.rig.Q,
                                  scale=1.0 / cfg.downscale,
                                  quirk_compat=cfg.quirk_compat,
                                  handle_missing=cfg.handle_missing,
                                  layout="chw")
            out = {"disparity": disp, "xyz": xyz, "confidence": conf,
                   "left_rectified": lrect, "right_rectified": rrect}
            if cfg.with_stats:
                out["frame_stats"] = batch_frame_stats(
                    disp, xyz[..., 2, :, :],
                    skip_cols=cfg.sgbm.num_disparities)
        return out

    # -- public API --------------------------------------------------------
    @staticmethod
    def xyz_hwc(xyz_chw: torch.Tensor) -> np.ndarray:
        """(..., 3, H, W) xyz -> host (..., H, W, 3) numpy view."""
        return np.moveaxis(xyz_chw.detach().cpu().numpy(), -3, -1)

    def process_pair(self, left, right) -> Dict[str, torch.Tensor]:
        """One frame pair (H, W[, 3]) -> disparity at matcher resolution,
        xyz (3, H, W) in mm (xyz_hwc gives the (H, W, 3) view), confidence,
        the rectified eyes and, with ``with_stats``, the (3,) stats."""
        with _span("sdr.call"):
            self._check_input_range(left)
            left = torch.as_tensor(left)[None]
            right = torch.as_tensor(right)[None]
            if self.device.type == "cuda":
                out = self._graphed(left, right)
            else:
                GRAPH_CALLS["eager"] += 1
                out = self._forward(left, right)
            return {k: v[0] for k, v in out.items()}

    def _graphed(self, left: torch.Tensor, right: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """``_forward`` of a (1, H, W[, 3]) pair run eagerly, or through the
        held graph as ``_graph_step`` decides. A replay's outputs are
        clones: the next replay overwrites the graph's own."""
        sig = (tuple(left.shape), left.dtype, tuple(right.shape), right.dtype)
        held = self._graph[0] if self._graph else None
        step = _graph_step(held, self._last_sig, sig)
        self._last_sig = sig
        if step == "eager":
            GRAPH_CALLS["eager"] += 1
            return self._forward(left, right)
        if step == "capture":
            self._graph = None      # the old graph's pool goes first
            ins = tuple(torch.empty(t.shape, dtype=t.dtype,
                                    device=self.device)
                        for t in (left, right))
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                outs = self._forward(*ins)
            self._graph = (sig, g, ins, outs)
        GRAPH_CALLS["captured" if step == "capture" else "replayed"] += 1
        _, g, ins, outs = self._graph
        with _span("sdr.upload"):
            ins[0].copy_(left)
            ins[1].copy_(right)
        g.replay()
        return {k: v.clone() for k, v in outs.items()}

    def process_batch(self, lefts, rights) -> Dict[str, torch.Tensor]:
        """(N, H, W[, 3]) batches -> the outputs of process_pair, each with
        a leading N."""
        with _span("sdr.call"):
            self._check_input_range(lefts)
            return self._forward(torch.as_tensor(lefts),
                                 torch.as_tensor(rights))

    def process_sbs(self, frame) -> Dict[str, torch.Tensor]:
        """Side-by-side frame (H, 2W[, 3]) -> split at W, then process."""
        w = self.rig.width
        return self.process_pair(frame[:, :w], frame[:, w:2 * w])

    def _check_input_range(self, arr) -> None:
        """remap_precision='u8' rounds/clips rectified samples to 0-255, so
        normalized (0..1) float input would be destroyed: warn once."""
        if (self.config.remap_precision != "u8" or not self.rectify
                or self._range_warned):
            return
        if isinstance(arr, np.ndarray) and arr.dtype.kind == "f" \
                and arr.size and float(arr.max()) <= 1.0:
            warnings.warn(
                "remap_precision='u8' expects 0-255 inputs but got float "
                "data with max <= 1.0 — values will be quantized to "
                "{0, 1}. Scale to 0-255 or set remap_precision='f32'.",
                stacklevel=3)
            self._range_warned = True
