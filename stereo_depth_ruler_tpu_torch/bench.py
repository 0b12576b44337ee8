"""Benchmark of the port: stereo frames/s on one card at 1280x720 x 128
disparities against the OpenCV CPU baseline (BASELINE.json's primary
metric).

Port of ``bench.py``: the same inputs, cv2 method, flags and JSON keys,
plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions) and a ``device`` key naming the card and its power limit. The
frames are uploaded once; every configuration is timed on device-resident
float32 batches as ``reps`` runs of ``iters`` back-to-back calls between
CUDA events (the median run gives frames/s), each run also timed by the
host clock up to a synchronize. ``compile_s`` is the first call,
synchronised, on the host clock: the kernels' load and first launches,
and their nvcc build where the checkout has none yet.

    python -m stereo_depth_ruler_tpu_torch.bench [--no-full] [--sweep]
        [--iters 8] [--cv-frames 30] [--device cuda]

Prints ONE JSON line to stdout; details go to stderr. The plain matcher
is the kernels' reference in the tests and in ``chip_smoke.py``, not a
timed configuration: the JAX bench's ``--no-pallas`` has no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .calib.config import StereoRig
from .cli import bench_arguments
from .entry import flagship_params, full_pipeline
from .io.synthetic import make_scene, render_stereo_pair
from .ops.reproject import reproject_to_3d
from .ops.sgbm_cuda import sgbm_cuda
from .pipeline import _resolve_device
from .utils import kernels

H, W, D = 720, 1280, 128
BATCH = 8
# the stress configuration (bench.py:181-215): one 2560x1440 frame, 256
# disparities, the right view the left one rolled by SWEEP_SHIFT columns
SWEEP = (1440, 2560, 256)
SWEEP_SHIFT = 20
SWEEP_KEY = "sweep_2560x1440x256_fps"
REPS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_inputs(batch=BATCH):
    """(rig, lefts, rights): ``batch`` uint8 frames of the synthetic rig's
    5-box scene (seed 0), each frame shifted 2 px from the one before."""
    rig = StereoRig.synthetic(width=W, height=H)
    scene = make_scene(rig, n_boxes=5, z_range_mm=(900.0, 4000.0),
                       background_z_mm=6000.0, seed=0)
    lefts, rights = [], []
    for i in range(batch):
        l, r, _ = render_stereo_pair(scene, seed=0, shift=(2.0 * i, 0.0))
        lefts.append(l)
        rights.append(r)
    return rig, np.stack(lefts), np.stack(rights)


def sweep_inputs(height, width):
    """The stress configuration's float32 pair: uniform noise (seed 0) and
    the same rolled by SWEEP_SHIFT columns."""
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (height, width)).astype(np.float32)
    return left, np.roll(left, -SWEEP_SHIFT, axis=1)


def host_cpu() -> str:
    """The host CPU's model (/proc/cpuinfo, else the platform's processor
    and machine names) and the CPUs this process may run on."""
    name = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            if key.strip() in ("model name", "Model", "cpu model"):
                name = value.strip()
                if name:
                    break
    except OSError:
        pass
    name = name or platform.processor() or platform.machine() or "unknown"
    return f"{name}, {len(os.sched_getaffinity(0))} CPUs"


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return (f"{torch.cuda.get_device_name(device)}, power limit not "
                f"read")


def bench_opencv(lefts, rights, frames=30, trials=5):
    """Reference-parameter cv2.StereoSGBM at the headline configuration
    (numDisparities=128; the other parameters as stereo_disparity.cpp:5-9).

    Pinned method: a warm-up, >= 30 frames per trial, the median of >= 5
    trials, the spread logged; cv2's threading at its default (the
    reference runs OpenCV's own thread pool). The host CPU and cv2's
    thread count are logged: the baseline is the card machine's CPU."""
    import cv2
    matcher = cv2.StereoSGBM_create(
        minDisparity=0, numDisparities=D, blockSize=5,
        P1=8 * 3 * 25, P2=32 * 3 * 25, disp12MaxDiff=1, preFilterCap=63,
        uniquenessRatio=12, speckleWindowSize=200, speckleRange=2,
        mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY)
    matcher.compute(lefts[0], rights[0])  # warm
    fps = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for n in range(frames):
            matcher.compute(lefts[n % len(lefts)], rights[n % len(rights)])
        fps.append(frames / (time.perf_counter() - t0))
    fps.sort()
    med = fps[len(fps) // 2]
    log(f"OpenCV trials fps: {fps} median {med} spread "
        f"{(fps[-1] - fps[0]) / med * 100:.1f}% ({trials} trials of "
        f"{frames} frames; host CPU {host_cpu()!r}, cv2 "
        f"{cv2.__version__}, {cv2.getNumThreads()} threads)")
    return med


@dataclasses.dataclass
class Run:
    """One timed configuration. ``fps`` comes from the median of the
    event spans; ``event_ms`` and ``host_ms`` are each run's device and
    host-clock spans; ``first`` the first call's outputs and ``first_s``
    its seconds; ``calls`` every call made (launch counts are per call);
    ``peak_bytes`` the peak device memory (None on the CPU)."""
    fps: float
    event_ms: List[float]
    host_ms: List[float]
    first: object
    first_s: float
    calls: int
    peak_bytes: Optional[int]


def _timed(fn, frames: int, iters: int, device: torch.device,
           reps: int = REPS) -> Run:
    """The first call synchronised on the host clock, a warm-up call, then
    ``reps`` runs of ``iters`` back-to-back calls. On the card each run
    lies between two CUDA events (the device's span) and is also timed on
    the host from before its first launch to after a synchronize; on the
    CPU both spans are the host clock's."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    first = fn()
    sync()
    first_s = time.perf_counter() - t0
    fn()
    event_ms, host_ms = [], []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(iters):
            fn()
        if cuda:
            end.record()
        sync()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end) if cuda else host_ms[-1])
    med = sorted(event_ms)[reps // 2]
    return Run(fps=iters * frames / (med / 1e3), event_ms=event_ms,
               host_ms=host_ms, first=first, first_s=first_s,
               calls=2 + reps * iters,
               peak_bytes=torch.cuda.max_memory_allocated(device)
               if cuda else None)


def _upload(frames, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(frames, np.float32)).to(device)


def _report(tag: str, run: Run, disp: torch.Tensor, state: str) -> None:
    peak = ("not measured (CPU)" if run.peak_bytes is None
            else f"{run.peak_bytes / 2**30:.3f} GiB")
    log(f"{tag}: first call {run.first_s:.3f} s ({state}); {run.fps} "
        f"frames/s; event ms {run.event_ms}, host-clock ms {run.host_ms}; "
        f"valid disparity frac {float((disp >= 0).float().mean())}; peak "
        f"memory {peak}")


def _kernel_state(device: torch.device) -> str:
    """What the first call will include beside the first launches."""
    if device.type != "cuda":
        return "plain versions on the CPU"
    return {"loaded": "kernels already loaded",
            "built": "kernels loaded, already built",
            "not built": "kernels built by nvcc and loaded"}[kernels.status()]


def bench_flagship(rig, lefts, rights, iters=8, device="cuda") -> Run:
    """The headline configuration: the matcher with the LR check and
    speckle 200/2, then the Q reprojection's depth, on one batch of
    device-resident float32 frames a call."""
    dev = _resolve_device(device)
    params = flagship_params(D)
    Q = rig.Q
    lb, rb = _upload(lefts, dev), _upload(rights, dev)

    def one():
        disp = sgbm_cuda(lb, rb, params, apply_lr=True, apply_speckle=True)
        return disp, reproject_to_3d(disp, Q)[..., 2]

    state = _kernel_state(dev)
    run = _timed(one, lb.shape[0], iters, dev)
    _report(f"flagship {W}x{H}x{D} batch {lb.shape[0]}", run, run.first[0],
            state)
    return run


def bench_full_pipeline(rig, lefts, rights, iters=4, device="cuda") -> Run:
    """The reference's complete step (rectify, SGBM x2 with the right
    matcher, WLS, reproject, stats): ``StereoPipeline._forward`` on
    device-resident float32 batches, the upload outside the clock."""
    dev = _resolve_device(device)
    pipe = full_pipeline(rig, flagship_params(D), dev)
    lb, rb = _upload(lefts, dev), _upload(rights, dev)
    state = _kernel_state(dev)
    run = _timed(lambda: pipe._forward(lb, rb), lb.shape[0], iters, dev)
    _report(f"full pipeline {W}x{H}x{D} batch {lb.shape[0]}", run,
            run.first["disparity"], state)
    return run


def bench_sweep(iters=4, device="cuda") -> Run:
    """The stress configuration: the matcher (LR, speckle 200/2) on one
    2560x1440 frame with 256 disparities."""
    dev = _resolve_device(device)
    Hs, Ws, Ds = SWEEP
    params = flagship_params(Ds)
    left, right = sweep_inputs(Hs, Ws)
    lt, rt = _upload(left[None], dev), _upload(right[None], dev)
    state = _kernel_state(dev)
    run = _timed(lambda: sgbm_cuda(lt, rt, params), 1, iters, dev)
    _report(f"sweep {Ws}x{Hs}x{Ds}", run, run.first, state)
    return run


def result_line(cv_fps: float, flagship: Run, full: Optional[Run],
                sweep: Optional[Run], device_name: str) -> dict:
    """The JSON line: bench.py's keys and meanings, plus ``device``.
    ``compile_s`` holds the first calls of the flagship ("sgbm") and the
    full pipeline."""
    compile_s = {"sgbm": round(flagship.first_s, 3)}
    line = {"metric": f"stereo_fps_per_chip_{W}x{H}_{D}disp_sgbm",
            "value": round(flagship.fps, 3), "unit": "frames/s",
            "vs_baseline": round(flagship.fps / cv_fps, 3),
            "cv_baseline_fps": round(cv_fps, 3), "compile_s": compile_s}
    if full is not None:
        compile_s["full_pipeline"] = round(full.first_s, 3)
        # the CPU baseline is one matcher pass; the full pipeline adds
        # rectify, a second matcher and WLS, so this ratio is conservative
        line["full_pipeline_fps"] = round(full.fps, 3)
        line["full_pipeline_vs_cv_sgbm"] = round(full.fps / cv_fps, 3)
    if sweep is not None:
        line[SWEEP_KEY] = round(sweep.fps, 3)
    line["device"] = device_name
    return line


def run(args) -> int:
    """Run the benchmark for parsed ``args``; print the JSON line."""
    dev = _resolve_device(args.device)
    rig, lefts, rights = make_inputs()
    log("benchmarking OpenCV CPU baseline...")
    cv_fps = bench_opencv(lefts, rights, frames=args.cv_frames)
    log(f"OpenCV CPU SGBM_3WAY {W}x{H}x{D}: {cv_fps} fps")

    log(f"benchmarking {dev}...")
    flagship = bench_flagship(rig, lefts, rights, iters=args.iters,
                              device=dev)
    flagship.first = None
    full = sweep = None
    if not args.no_full:
        full = bench_full_pipeline(rig, lefts, rights,
                                   iters=max(2, args.iters // 2), device=dev)
        full.first = None
    if args.sweep:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        sweep = bench_sweep(device=dev)
    print(json.dumps(result_line(cv_fps, flagship, full, sweep,
                                 card_name(dev))), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench", description=__doc__)
    bench_arguments(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
