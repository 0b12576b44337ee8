"""The stereo pipeline's driver (drivers/__init__.py says what a driver
gives): ``StereoPipeline`` of the port on the configuration's rig and
settings, driven through ``process_batch`` or ``process_pair``, each
call's frame stats fetched, judged by ``harness/check.compare`` against
the frozen plain reference (``reference.run``) of the whole step."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import reference
from harness import check

ENTRIES = {"process_batch": None, "process_pair": (1,)}
NAMES = check.NAMES


def build(config: dict, rig: dict, device):
    """StereoPipeline on the configuration's rig and settings; the
    reference covers the right matcher + WLS path only."""
    if not (config["pipeline"]["use_wls"]
            and config["pipeline"]["lr_mode"] == "right_matcher"):
        raise ValueError("the reference covers the right matcher + WLS path")
    from stereo_depth_ruler_tpu_torch.calib.config import StereoRig
    from stereo_depth_ruler_tpu_torch.ops.sgbm_ref import SGBMParams
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    stereo = StereoRig(image_size=(rig["width"], rig["height"]),
                       camera_matrix_left=rig["K1"],
                       dist_coeffs_left=rig["dist1"],
                       camera_matrix_right=rig["K2"],
                       dist_coeffs_right=rig["dist2"], R=rig["R"],
                       T=rig["T"], R1=rig["R1"], R2=rig["R2"],
                       P1=rig["P1"], P2=rig["P2"], Q=rig["Q"])
    p = config["sgbm"]
    params = SGBMParams(min_disparity=p["min_disparity"],
                        num_disparities=p["num_disparities"],
                        block_size=p["block_size"], p1=p["p1"], p2=p["p2"],
                        disp12_max_diff=p["disp12_max_diff"],
                        pre_filter_cap=p["pre_filter_cap"],
                        uniqueness_ratio=p["uniqueness_ratio"],
                        speckle_window_size=p["speckle_window_size"],
                        speckle_range=p["speckle_range"],
                        num_paths=p["num_paths"],
                        quantize_16=p["quantize_16"])
    return StereoPipeline(stereo, PipelineConfig(sgbm=params,
                                                 **config["pipeline"]),
                          device=device)


def call(pipe, entry: str, pool, seq: np.ndarray, batch: int):
    """``process_batch`` on the slot's batch, stacked before the window, or
    ``process_pair`` on the call's one pool pair."""
    pool_l, pool_r = pool
    if entry == "process_batch":
        slots = [(np.ascontiguousarray(pool_l[seq[k:k + batch]]),
                  np.ascontiguousarray(pool_r[seq[k:k + batch]]))
                 for k in range(0, len(seq), batch)]

        def call_program(slot, pairs):
            return pipe.process_batch(*slots[slot])
    else:
        def call_program(slot, pairs):
            return pipe.process_pair(pool_l[pairs[0]], pool_r[pairs[0]])
    return call_program


def fetch(out) -> np.ndarray:
    """The call's (frames, 3) frame stats on the host."""
    return out["frame_stats"].cpu().numpy().reshape(-1, 3)


class Holder:
    """Keeps a copy of the outputs of one frame of each checked pair, chosen
    among the pair's frames in the window by reservoir sampling from the
    seed. The copies go to buffers allocated before the window (``prepare``)
    by one device-to-device copy per output, so that holding allocates
    nothing inside it."""

    def __init__(self, checked, seed: int, batched: bool):
        self.rng = np.random.default_rng([seed % (1 << 64), 2])
        self.seen = {int(p): 0 for p in checked}
        self.batched = batched
        self.buf: Dict[int, Dict[str, torch.Tensor]] = {}
        self.held = set()

    def _frame(self, out, k):
        return {name: (v[k] if self.batched else v)
                for name, v in out.items() if name != "frame_stats"}

    def prepare(self, out) -> None:
        for p in self.seen:
            self.buf[p] = {name: torch.empty_like(v)
                           for name, v in self._frame(out, 0).items()}

    def offer(self, pairs, out) -> None:
        for k, p in enumerate(pairs):
            p = int(p)
            if p in self.seen:
                self.seen[p] += 1
                if self.rng.random() * self.seen[p] < 1.0:
                    for name, v in self._frame(out, k).items():
                        self.buf[p][name].copy_(v)
                    self.held.add(p)

    def frames(self):
        return [(p, self.buf[p]) for p in sorted(self.held)]


def holder(entry: str, checked, seed: int) -> Holder:
    return Holder(checked, seed, entry == "process_batch")


def compare(held, fetched, pool, rig: dict, config: dict, device
            ) -> Dict[str, float]:
    """``check.compare``'s numbers against the reference run on the held
    pairs' host frames, ``reference_block`` pairs at a time."""
    pool_l, pool_r = pool
    pairs = sorted(p for p, _ in held)
    ref_out = reference.run(pool_l[pairs], pool_r[pairs], rig, config,
                            device, block=int(config["reference_block"]))
    ref = {p: {k: v[i] for k, v in ref_out.items()}
           for i, p in enumerate(pairs)}
    return check.compare(held, fetched, ref)
