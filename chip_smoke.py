#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: builds the CUDA kernels from ops/csrc with nvcc, one process per
   source, all started together;
3. kernels: K1 cost, K2's 8 passes and K3 (LR on and off) against their
   plain PyTorch versions, bitwise, at 32x48x16, 96x160x48 and
   720x1280x128; at the same shapes the staged chain's kernels (the fused
   cost + down pass, K2 on an int16 S, the three-input WTA/LR) with 8, 4
   and 2 paths and min_disparity 0 and 3, and the three transposes on
   int16, int32 and bfloat16 volumes; then K4 speckle labels, K5 speckle keep, K7 shift
   gather and K6 FGS pass (all bitwise) at 32x48 and 96x160, and K4/K5
   on a 720x1280 serpentine, one component that a CCL stopping early
   splits;
4. matcher: sgbm_cuda against the NumPy oracle sgbm_ref.sgbm_numpy,
   bitwise, on a 32x48 synthetic pair with 16 disparities, speckle off
   (2, 4 and 8 paths) and on;
5. main path, slice 1: StereoPipeline.process_batch on 8 synthetic
   1280x720 frames (u8 rectify, 128 disparities, 8 paths, in-matcher LR,
   speckle off), checked against the rendered ground truth, with launch
   counts (K1 and the batch route's agg_down, agg_horiz, agg_up_wta and
   agg_lr once each, nothing else), frames/s and peak memory; then K1-K3
   on the main path's own inputs (8x720x1280x128) against their plain
   versions, bitwise, and timed; the batch route's kernels on the same
   volume against their plain stages, bitwise, and timed beside their
   bounds; the two matcher routes (K2 x8 + K3, and the batch sweeps) in
   turns at batch 8 and batch 1 with their peak memory; a counted run of
   sgbm_cuda(fused_wta=False), which must launch K1, K2 x8 and K3 alone
   and give the path's map; then the staged chain on the same rectified frames: a counted
   run of sgbm_staged_cuda, which must launch the fused cost + down kernel
   once, K2 on an int16 S five times and the three-input WTA/LR once, and
   none of K1-K3; its map equal to sgbm_cuda's and to the slice-1 path's;
   cost_down's C equal to K1's and its sum to three K2 passes; the three
   kernels against their plain versions on the full batch, timed, the two
   chains timed in turns at batch 8 and on one frame pair (their maps
   equal at both), and their peak memory; then a counted run of
   the stage profiler (tools/profile_stages_torch.py), which launches the
   three volume transposes, and the transposes on one frame's volume
   ((128, 720, 1280), int16, int32 and bfloat16) against
   permute().contiguous(), bitwise, there and back, and timed;
6. full main path: the same frames through the reference's configuration
   (speckle 200/2, right matcher on the stacked 16 frames, WLS filter), at
   the WLS accuracy bar (valid > 0.95, MAE < 0.7 px outside the left 128
   columns), with launch counts proving K1-K7 ran, frames/s and peak
   memory; then K1-K7 on that path's own inputs (K1-K3 on the 16 stacked
   frames, 16x720x1280x128, where the two matcher routes are also timed in
   turns) against their plain versions, bitwise, and
   K4-K7 timed (K5 beside scatter_add_, its histogram alone; K7 in turns
   with torch.gather, the gather alone), and
   K4's and K5's three launches each timed apart (CUDA events between
   them, through speckle.cu's part entries); K6 on the WLS inputs of one
   frame and of eight, rows and columns apart, bitwise at each of the
   three lambdas and timed beside its bound; then torch.profiler traces
   three batches of the
   full path for the device time per kernel and the device's busy share;
   the full path launches exactly K1-K7;
7. sort family: on the full path's 16 matcher maps (before the speckle
   filter) and their K4 labels, a counted run of the capped
   speckle_filter (max_iters 3), speckle_keep_seeded and
   equal_value_counts, which must launch the sweep kernel's two modes,
   the radix sort's two and the sorted-run kernel's three; then each of
   them against its plain version, bitwise: the sweep's labels mode at
   1, 2 and 3 rounds and converged (equal to K4) on the maps and the
   720x1280 serpentine, its propagate mode, the sorts against
   torch.sort(stable=True) on 16 x 2^20 keys, on the unpadded labels (the
   top digit constant, its pass skipped; timed beside), the run modes
   and their compositions on the maps' labels and on the serpentine's,
   sizes on all-distinct keys, the seeded keep against K5's; then times
   (kernel, plain, torch.sort for the sorts), the cost of the host's flag
   reads in a converged sweep, bounds, and the sizes kernel's split: the
   real keys and source indices, no source indices, distinct keys;
8. shared path: the full path's configuration with pair_mode="shared"
   (K1's pair mode builds both matchers' volumes in one launch, the batch
   route's mirror mode runs the right matcher's WTA/LR), at the WLS bar,
   with launch counts proving both modes ran; every output equal to the
   stacked path's; ms per batch at batch 8 and ms per process_pair at
   batch 1 for both pair modes, timed in turns; then K1's pair mode, K2
   and K3's mirror mode on the path's own inputs (8x720x1280x128, both
   volumes) against their plain versions frame by frame, bitwise, the two
   modes timed; the batch route's kernels in mirror mode against their
   plain stages and K3's mirror mode, and the two matcher routes in turns
   on the pair volume; sgbm_pair_cuda's two maps equal to the stacked
   matcher's, and a counted run of sgbm_pair_cuda(fused_wta=False) (K1's
   pair mode, K2 x8, K3's mirror mode, K4, K5); then a profile of the
   shared path;
9. configurations: K1 and its pair mode at blocks 1, 3, 7, 9 and 11 on a
   720x1280x128 frame against their plain versions, bitwise, and timed;
   StereoPipeline at
   the reference's defaults (downscale 2, 80 disparities, speckle 200/2,
   right matcher, WLS) on BGR frames with remap_precision="f32", and with
   lr_mode="none" and no WLS, each equal to the plain chain on its own
   rectified frames; the stress shape 2560x1440x256 on one frame: K1-K3,
   the batch route's kernels and K1's pair mode against their plain
   versions (the pair mode timed), the two matcher routes in turns,
   the fused and staged matcher equal, and K4/K5 on the matcher's map
   against their plain versions, bitwise, and timed;
10. sharded (stereo_depth_ruler_tpu_torch/parallel): a world of one NCCL
   rank on the mesh (1, 1, 1); sgbm_sharded on one bench frame (speckle
   200/2) equal to sgbm_cuda, launching K1, the tile matcher K9
   (sgbm_tile_cuda: the batch route's down, horizontal and up + WTA
   sweeps and its LR pass on the slab, no K2 or K3) and K4/K5 once each;
   pipeline_step_sharded at batch 8 with rects and WLS, its disparity and
   xyz equal to the frame-by-frame composition of the port's functions,
   launching K1, K9 (two a frame), K6 and K7 and nothing else, at the WLS
   bar, timed in turns with the full path, and its peak memory; K9 in
   this process at 2 tiles with a full-coverage halo equal to the whole
   frame, at halo 64 on 2 and 4 tiles within max |err| 1/16 px and an
   exact fraction of 0.9999, sgbm_tile_cuda against plain.sgbm_tile and
   against the int32 route (K2 x8 and K3) bitwise on slabs with halos of
   0, 8 and 64 (zero rows beyond the image included), LR on and off, and
   each of the batch route's kernels on the slabs against its plain stage
   (their records keep the worse error of the batch and the slabs); K9 and
   the int32 route timed in turns on the whole-frame slab, each sweep
   timed (logged; the records keep the batch's times); then
   per tile at 720x1280x128 and 2560x1440x256 for 1, 2 and 4 tiles: the
   two routes in turns on the tile's slab, and ms and peak memory per tile
   (slab build and K9) for each route;
11. host (the CLI and the point cloud, in a temp dir): the CLI's synth
   writes 128 frames of 1280x720 (seed 0; 16 batches, so that the
   pipeline's fill is a small part of the timed run), and a BGR copy with
   channels
   that differ; the CLI's run on each (batch 8, 128 disparities, the
   full path's settings), which must launch per batch K1, the batch
   route's four kernels, K4, K5, K7 and K6 x6 and nothing else, its per-frame metrics bitwise
   equal to StereoPipeline.process_batch on the same VideoSource frames,
   its video_end_to_end_fps printed beside that loop's frames/s and the
   upload's ms per batch; the CLI's cloud of frame 3: the disparity of
   its matcher (K1-K5) bitwise equal to the plain matcher on the card,
   the voxel count and order equal to voxel_downsample on the CPU on the
   card's own kept points (centroids at atol 1e-3), the PCD file too, ms
   per cloud_from_pair with its split (matcher, reproject + keep, voxel,
   PCD write); the CLI's measure on two points of the nearest box equal
   to measure_distance on the pipeline's own xyz, beside the ground truth;
12. bench (stereo_depth_ruler_tpu_torch/bench.py and entry.py): the
   pinned cv2.StereoSGBM baseline (30 frames x 5 trials, the host CPU and
   cv2's threads logged); bench_flagship on bench.make_inputs() (batch 8,
   1280x720x128, LR, speckle 200/2, reprojected depth), its first batch
   bitwise equal to the plain matcher + reproject_to_3d frame by frame;
   bench_full_pipeline, its disparity and xyz bitwise equal to
   StereoPipeline.process_batch on the uint8 frames; bench_sweep
   (2560x1440x256) bitwise equal to the plain matcher; the launches of
   every call exact (the matcher: K1, the batch route's four kernels, K4,
   K5; the full path: those, K7 and K6 x6); each timed run's CUDA-event span within 5 % of
   its host-clock span; entry()'s forward bitwise equal to the plain
   matcher and entry_full_pipeline()'s launching the full path once;
   then the card and the bench's JSON line.

The last lines are the card's name and power limit, a JSON object with one
record per kernel, and the JSON object {"ok": true, "device": {...}}. The
port imports no JAX and nothing of the JAX package; the run checks that
JAX stays unloaded.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# kernel name -> (source, replaced TPU kernel)
KERNELS = {
    "cost_box": ("stereo_depth_ruler_tpu_torch/ops/csrc/cost_box.cu",
                 "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:92"),
    "cost_box_pair": ("stereo_depth_ruler_tpu_torch/ops/csrc/cost_box.cu",
                      "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:92"),
    "sgm_pass": ("stereo_depth_ruler_tpu_torch/ops/csrc/sgm_pass.cu",
                 "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:606"),
    "wta_lr": ("stereo_depth_ruler_tpu_torch/ops/csrc/wta_lr.cu",
               "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1463"),
    "wta_lr_mirror": ("stereo_depth_ruler_tpu_torch/ops/csrc/wta_lr.cu",
                      "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1147"),
    "speckle_labels": ("stereo_depth_ruler_tpu_torch/ops/csrc/speckle.cu",
                       "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1656"),
    "speckle_keep": ("stereo_depth_ruler_tpu_torch/ops/csrc/speckle.cu",
                     "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1781"),
    "fgs_pass": ("stereo_depth_ruler_tpu_torch/ops/csrc/fgs_pass.cu",
                 "stereo_depth_ruler_tpu/ops/wls_pallas.py:70"),
    "shift_gather": ("stereo_depth_ruler_tpu_torch/ops/csrc/shift_gather.cu",
                     "stereo_depth_ruler_tpu/ops/wls_pallas.py:147"),
    "sweep_labels": ("stereo_depth_ruler_tpu_torch/ops/csrc/sweep.cu",
                     "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1656"),
    "sweep_propagate": ("stereo_depth_ruler_tpu_torch/ops/csrc/sweep.cu",
                        "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1781"),
    "radix_sort_keys": ("stereo_depth_ruler_tpu_torch/ops/csrc/radix_sort.cu",
                        "stereo_depth_ruler_tpu/ops/sort_tpu.py:404"),
    "radix_sort_pairs": ("stereo_depth_ruler_tpu_torch/ops/csrc/radix_sort.cu",
                         "stereo_depth_ruler_tpu/ops/sort_tpu.py:89"),
    "sorted_runs_sizes": (
        "stereo_depth_ruler_tpu_torch/ops/csrc/sorted_runs.cu",
        "stereo_depth_ruler_tpu/ops/sort_tpu.py:317"),
    "sorted_runs_keep": (
        "stereo_depth_ruler_tpu_torch/ops/csrc/sorted_runs.cu",
        "stereo_depth_ruler_tpu/ops/sort_tpu.py:455"),
    "sorted_runs_roots": (
        "stereo_depth_ruler_tpu_torch/ops/csrc/sorted_runs.cu",
        "stereo_depth_ruler_tpu/ops/sort_tpu.py:510"),
    "cost_down": ("stereo_depth_ruler_tpu_torch/ops/csrc/cost_down.cu",
                  "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:276"),
    "sgm_pass_i16": ("stereo_depth_ruler_tpu_torch/ops/csrc/sgm_pass.cu",
                     "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:606"),
    "wta_lr3": ("stereo_depth_ruler_tpu_torch/ops/csrc/wta_lr.cu",
                "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1445"),
    "transpose_vol": ("stereo_depth_ruler_tpu_torch/ops/csrc/transpose.cu",
                      "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:469"),
    "transpose_leading": (
        "stereo_depth_ruler_tpu_torch/ops/csrc/transpose.cu",
        "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:481"),
    "transpose_dhw": ("stereo_depth_ruler_tpu_torch/ops/csrc/transpose.cu",
                      "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:511"),
    # K9, the tile matcher: sgbm_tile_cuda on a slab that K1 builds; at the
    # paths' parameters the batch route's sweeps and LR pass (the agg_*
    # records below) on the slab as a batch of one frame
    "sgbm_tile": ("stereo_depth_ruler_tpu_torch/ops/csrc/tile_sgm.cu",
                  "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1095"),
    # the matcher's batch route (aggregate_wta at its defaults): the
    # kernels of tile_sgm.cu over a batch of frames, the JAX main path's
    # _fused_aggregate_wta (rows 2 and 3)
    "agg_down": ("stereo_depth_ruler_tpu_torch/ops/csrc/tile_sgm.cu",
                 "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:606"),
    "agg_horiz": ("stereo_depth_ruler_tpu_torch/ops/csrc/tile_sgm.cu",
                  "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:606"),
    "agg_up_wta": ("stereo_depth_ruler_tpu_torch/ops/csrc/tile_sgm.cu",
                   "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1463"),
    "agg_up_wta_mirror": ("stereo_depth_ruler_tpu_torch/ops/csrc/tile_sgm.cu",
                          "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1147"),
    "agg_lr": ("stereo_depth_ruler_tpu_torch/ops/csrc/tile_sgm.cu",
               "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1147"),
}
# the batch route's kernels, launched once each per matcher call and per
# K9 call (agg_lr with the LR check) on every path at its defaults
AGG = ("agg_down", "agg_horiz", "agg_up_wta", "agg_lr")
# the pair modes, launched only by the shared path
PAIR_MODES = ("cost_box_pair", "agg_up_wta_mirror")
# K2 and K3, launched where agg_route picks "passes": counted in a run of
# sgbm_cuda(fused_wta=False) (wta_lr_mirror: sgbm_pair_cuda's)
PASSES = {"sgm_pass": 8, "wta_lr": 1}
# the kernels the full path launches, and no other
FULL_PATH = {"cost_box", *AGG, "speckle_labels", "speckle_keep", "fgs_pass",
             "shift_gather"}
# the sort family's kernels, launched by its entry points only
SORT_FAMILY = ("sweep_labels", "sweep_propagate", "radix_sort_keys",
               "radix_sort_pairs", "sorted_runs_sizes", "sorted_runs_keep",
               "sorted_runs_roots")
# the staged chain's kernels and their launches per sgbm_staged_cuda call
# with 8 paths, and the transposes, launched by the stage profiler
STAGED_CHAIN = {"cost_down": 1, "sgm_pass_i16": 5, "wta_lr3": 1}
TRANSPOSES = ("transpose_vol", "transpose_leading", "transpose_dhw")
# K4's and K5's sub-launches, in order (speckle.cu's part entries)
SPECKLE_PARTS = {"speckle_labels": ("tiles", "borders", "resolve"),
                 "speckle_keep": ("count", "add", "apply")}
DEVICE = "cuda"
# (H, W, D) of the K1-K3 checks; the serpentine's (H, W); the main path's
# batch, H, W and D (the JAX package's headline widths)
KERNEL_SHAPES = ((32, 48, 16), (96, 160, 48), (720, 1280, 128))
SERPENTINE = (720, 1280)
MAIN = (8, 720, 1280, 128)
# (H, W, D) of the stress shape (the JAX package's bench.py:181-192)
STRESS = (1440, 2560, 256)
# the host phase: frames, H, W and D of the synthetic video, and the CLI's
# batch; the full path's launches per batch, and the matcher's with the
# speckle filter per call (the cloud's, the bench flagship's, entry()'s)
HOST = (128, 720, 1280, 128)
HOST_BATCH = 8
FULL_PATH_PER_BATCH = {"cost_box": 1, **dict.fromkeys(AGG, 1),
                       "speckle_labels": 1, "speckle_keep": 1,
                       "shift_gather": 1, "fgs_pass": 6}
MATCHER_PER_CALL = {"cost_box": 1, **dict.fromkeys(AGG, 1),
                    "speckle_labels": 1, "speckle_keep": 1}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches (after one
    warm-up call), timed with CUDA events."""
    from stereo_depth_ruler_tpu_torch.utils.profiling import stage_time
    return stage_time(fn, reps)


def max_abs_err(a, b):
    """Largest |a - b| (inf if the shapes differ)."""
    a = a.double()
    b = b.double()
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).abs().max()) if a.numel() else 0.0


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate (the H100's, utils/profiling.py)."""
    from stereo_depth_ruler_tpu_torch.utils.profiling import (
        FP32_OPS_PER_S, HBM_BYTES_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # exactness: no TF32 anywhere (the plain versions use no convolution
    # or matmul, this makes sure nothing else does either)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    return card


def phase_build():
    from stereo_depth_ruler_tpu_torch.utils import kernels
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name} from "
        f"{len(list(kernels.CSRC_DIR.glob('*.cu')))} sources")
    ptxas = lib.with_suffix(".log").read_text()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", ptxas)]
    log(f"ptxas: {len(regs)} kernel instances, registers "
        f"{min(regs)}..{max(regs)}, spill stores {max(spills)} bytes max")
    entries = ptxas_entries(ptxas)
    # K1 at every block size: the row-sliding single-volume kernel; the
    # pair kernel at block 5 (the main paths'), which must not move
    log("ptxas: K1 cost_box_kernel by block: " + ", ".join(
        f"{b}: {n} registers, {sp} B spilled" for name, b, n, sp in entries
        if name == "cost_box_kernel"))
    log("ptxas: K1 pair cost_pair_strip_kernel by <block,columns>: "
        + ", ".join(f"<{b}>: {n} registers, {sp} B spilled"
                    for name, b, n, sp in entries
                    if name == "cost_pair_strip_kernel"))
    # the sweep kernel's three kernels, by mode (Min: labels, Max:
    # propagate; the init kernel by its link test)
    log("ptxas: sweep " + ", ".join(ptxas_named(
        ptxas, r"(sweep_init|sweep_rows|sweep_cols)INS_\d+(\w+?)E")))
    # K4's and K5's three launches each
    log("ptxas: K4/K5 " + ", ".join(ptxas_named(
        ptxas, r"\d(labels_tiles|labels_borders|labels_resolve|"
        r"keep_count|keep_add|keep_apply)E")))
    # the sorted-run kernel: sizes, keep (runs_sizes<mode>) and roots
    log("ptxas: sorted_runs " + ", ".join(ptxas_named(
        ptxas, r"(runs_sizes|runs_roots)(?:ILi(\d)E)?")))
    # K6 by <lines a block, rows>
    log("ptxas: K6 " + ", ".join(f"{name}<{t}> {n} registers, {sp} B spilled"
                                 for name, t, n, sp in entries
                                 if name == "fgs_pass_kernel"))
    # cost_down at every <BLOCK, words per lane>; registers are capped, so
    # the spills are what to watch (<5,2> is the timed 128-disparity one)
    log("ptxas: cost_down_kernel by <block,words>: " + ", ".join(
        f"<{t}>: {n} registers, {sp} B spilled"
        for name, t, n, sp in entries if name == "cost_down_kernel"))
    # the matcher kernels at 128 disparities (4 per lane): K2 and K3 as the
    # three paths run them, and the staged chain's beside them
    d128 = re.findall(
        r"entry function '\w*?\d+(sgm_pass_kernel|sgm_pass_i16_kernel|"
        r"wta_lr_kernel|wta_lr3_kernel)ILi4E(?:Lb([01])E)?"
        r"\w*'[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers", ptxas)
    # tile_sgm.cu: the sweeps by <words a lane, plan>, the horizontal walk
    # by disparities a lane / 4, the LR pass (K9's and the batch route's)
    log("ptxas: tile_sgm " + ", ".join(ptxas_named(
        ptxas, r"(tile_sweep_kernel|tile_horiz_kernel|tile_lr_kernel)"
        r"(?:I(Li\d+E(?:Li\d+E)?))?")))
    log("ptxas: at 4 disparities per lane: " + ", ".join(
        f"{name}{'<acc>' if acc == '1' else ''} {n} registers"
        for name, acc, n in d128))


def ptxas_named(ptxas, pattern):
    """'<name> <n> registers, <s> B spilled' for every kernel entry of an
    nvcc -Xptxas -v report whose mangled name matches ``pattern``: the
    name is its first group, with its second, where one matched, in
    angle brackets."""
    out = []
    for chunk in ptxas.split("Compiling entry function '")[1:]:
        m = re.search(pattern, chunk.split("'", 1)[0])
        n = re.search(r"Used (\d+) registers", chunk)
        sp = re.search(r"(\d+) bytes spill stores", chunk)
        if m and n:
            arg = m.group(2) if m.re.groups > 1 else None
            out.append(f"{m.group(1)}{f'<{arg}>' if arg else ''} "
                       f"{n.group(1)} registers, "
                       f"{sp.group(1) if sp else 0} B spilled")
    return out


def ptxas_entries(ptxas):
    """(kernel name, its leading template integers joined by ',' or '',
    registers, spill-store bytes) of every kernel entry in an nvcc -Xptxas
    -v report."""
    out = []
    for chunk in ptxas.split("Compiling entry function '")[1:]:
        head = chunk.split("'", 1)[0]
        n = re.search(r"Used (\d+) registers", chunk)
        sp = re.search(r"(\d+) bytes spill stores", chunk)
        # <length><name> of the mangling; a namespace hash may run into the
        # length's digits, so try every suffix of each digit run
        found = None
        for m in re.finditer(r"\d+", head):
            for k in range(m.start(), m.end()):
                name = head[m.end():m.end() + int(head[k:m.end()])]
                if name.endswith("_kernel"):
                    found = found or (name, m.end() + len(name))
        if found and n:
            t = re.match(r"I((?:Li\d+E)+)", head[found[1]:])
            ints = ",".join(re.findall(r"\d+", t.group(1))) if t else ""
            out.append((found[0], ints, int(n.group(1)),
                        int(sp.group(1)) if sp else 0))
    return out


def _pair(H, W, shift, seed):
    """Random-texture pair whose right view is the left one shifted."""
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (1, H, W)).astype(np.float32)
    right = np.roll(left, -shift, axis=2) + rng.normal(0, 2, (1, H, W))
    return left, np.clip(right, 0, 255).astype(np.float32)


def check_kernels(lt, rt, params, errs):
    """Run K1, K2 (one pass per direction) and K3 (LR on and off) on the
    (B, H, W) Sobel images lt, rt and hold each output against its plain
    version on the same input, frame by frame; raise on any difference.
    Keeps the largest error per kernel in errs; returns (C, S)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    C = sc.cost_volume(lt, rt, params)
    torch.cuda.synchronize()
    S = torch.empty(C.shape, dtype=torch.int32, device=C.device)
    for i, (dy, dx) in enumerate(params.path_dirs):
        sc.sgm_pass(C, S, dy, dx, params.P1, params.P2, i > 0)
        torch.cuda.synchronize()
    disp = {}
    for apply_lr in (True, False):
        disp[apply_lr] = sc.wta_lr(S, params, apply_lr)
        torch.cuda.synchronize()
    err = {"cost_box": 0.0, "sgm_pass": 0.0, "wta_lr": 0.0}
    for b in range(lt.shape[0]):
        C_p = plain.cost_volume(lt[b], rt[b], params)
        err["cost_box"] = max(err["cost_box"], max_abs_err(C[b], C_p))
        S_p = plain.aggregate_paths(C_p, params.P1, params.P2,
                                    params.num_paths)
        del C_p
        err["sgm_pass"] = max(err["sgm_pass"], max_abs_err(S[b], S_p))
        for apply_lr in (True, False):
            err["wta_lr"] = max(err["wta_lr"], max_abs_err(
                disp[apply_lr][b], plain.wta_lr(S_p, params, apply_lr)))
        del S_p
    B, H, W, D = C.shape
    log(f"kernels {B}x{H}x{W}x{D}: max|err| vs plain: "
        + ", ".join(f"{k} {v}" for k, v in err.items())
        + f" (valid {float((disp[True] >= 0).float().mean()):.3f})")
    for k, v in err.items():
        errs[k] = max(errs.get(k, 0.0), v)
    if any(err.values()):
        raise AssertionError(f"a kernel differs from its plain version: "
                             f"{err}")
    return C, S


def check_agg(card, C, params, errs, mirror_from, tag):
    """The batch route's kernels (csrc/tile_sgm.cu over a batch) on the
    (B, H, W, D) cost volume C, frames from ``mirror_from`` on mirrored:
    agg_down, agg_horiz, the up sweep with the WTA and the LR pass, each
    held against its plain stage (ops/sgbm.py) frame by frame, bitwise,
    then timed beside its plain version (run frame by frame over the
    batch, which keeps its float32 volumes to one frame's) and its bound.
    Keeps the largest error per kernel in errs; raises on any difference;
    returns (times, bounds)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    B, H, W, D = C.shape
    m = mirror_from
    up = "agg_up_wta" if m == B else "agg_up_wta_mirror"
    bias = sc.tile_bias(params)

    def per_frame(fn):
        def run():
            for b in range(B):
                fn(b)
        return run

    def plain_down(b):
        return plain.tile_down_sum(C[b:b + 1], params, 0, bias)

    def plain_horiz(b):
        return plain.tile_horizontal(C[b:b + 1], S[b:b + 1], params)

    def plain_up(b, lr=False):
        return plain.tile_up_wta(C[b:b + 1], S[b:b + 1], params, bias, lr,
                                 mirror_lr=b >= m)

    S = sc.agg_down(C, params, bias)
    torch.cuda.synchronize()
    S_down = S.clone()
    sc.agg_horiz(C, S, params)
    torch.cuda.synchronize()
    out, d2p = sc._agg_up(C, S, params, bias, True, m, H)
    torch.cuda.synchronize()
    out_up = out.clone()
    sc._agg_lr(out, d2p, params, m)
    torch.cuda.synchronize()
    err = dict.fromkeys(("agg_down", "agg_horiz", up, "agg_lr"), 0.0)
    for b in range(B):
        S_p = plain_down(b)
        err["agg_down"] = max(err["agg_down"],
                              max_abs_err(S_down[b:b + 1], S_p))
        S_p = plain.tile_horizontal(C[b:b + 1], S_p, params)
        err["agg_horiz"] = max(err["agg_horiz"], max_abs_err(S[b:b + 1],
                                                             S_p))
        del S_p
        err[up] = max(err[up], max_abs_err(out_up[b:b + 1], plain_up(b)))
        err["agg_lr"] = max(err["agg_lr"], max_abs_err(out[b:b + 1],
                                                       plain_up(b, True)))
    del S_down, out_up
    log(f"{tag} batch route {B}x{H}x{W}x{D}, mirrored from {m}: max|err| "
        "vs plain: " + ", ".join(f"{k} {v}" for k, v in err.items()))
    for k, v in err.items():
        errs[k] = max(errs.get(k, 0.0), v)
    if any(err.values()):
        raise AssertionError(f"a batch-route kernel differs from its plain "
                             f"stage: {err}")
    S_t = S.clone()
    times = {
        "agg_down": (cuda_ms(lambda: sc.agg_down(C, params, bias), 5),
                     cuda_ms(per_frame(plain_down), 1), None),
        "agg_horiz": (cuda_ms(lambda: sc.agg_horiz(C, S_t, params), 5),
                      cuda_ms(per_frame(plain_horiz), 1), None),
        up: (cuda_ms(lambda: sc._agg_up(C, S, params, bias, True, m, H),
                     5),
             cuda_ms(per_frame(plain_up), 1), None),
    }
    del S_t
    if m == B:
        # the LR pass's plain version: lr_check on each frame's 8-path sum
        # and its WTA
        wtas = []
        for b in range(B):
            S_f = plain.tile_up_sum(C[b:b + 1], S[b:b + 1], params, bias)
            wtas.append((S_f, *plain.wta(S_f, params)))
        times["agg_lr"] = (
            cuda_ms(lambda: sc._agg_lr(out, d2p, params, m), 10),
            cuda_ms(lambda: [plain.lr_check(*w, params) for w in wtas], 1),
            None)
        del wtas
    del S, out, d2p
    torch.cuda.empty_cache()
    el, px = B * H * W * D, B * H * W
    # bytes: each input read once, each output written once; operations
    # ~8 per element and path, ~4 per element for the WTA, ~4 per pixel
    # for the LR check
    bounds = {"agg_down": bound(4 * el, 8 * 3 * el),
              "agg_horiz": bound(6 * el, 8 * 2 * el),
              up: bound(4 * el + 8 * px, (8 * 3 + 4) * el),
              "agg_lr": bound(12 * px, 4 * px)}
    for name, (ms, plain_ms, _) in times.items():
        log(f"{tag} [{card}]: {name} at {B}x{H}x{W}x{D}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}), {ms / bounds[name][0]:.2f}x its bound")
    return times, bounds


def route_turns(card, C, params, mirror_from, tag):
    """sgbm_cuda.aggregate_wta on the (B, H, W, D) cost volume C by its two
    routes, K2 per direction + K3 (fused_wta=False) and the batch sweeps,
    their maps held equal, timed in turns (passes, sweeps, sweeps,
    passes), and the peak device memory each adds to C; returns the ms of
    (passes, sweeps)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    B, H, W, D = C.shape
    runs = [lambda: sc.aggregate_wta(C, params, mirror_from=mirror_from,
                                     fused_wta=False),
            lambda: sc.aggregate_wta(C, params, mirror_from=mirror_from)]
    if sc.agg_route(params) != "sweeps":
        raise AssertionError(f"{tag}: the defaults do not take the sweeps")
    peak = []
    for fn in runs:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        peak.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        if len(peak) == 1:
            want = got
        elif not torch.equal(got, want):
            raise AssertionError(f"{tag}: the two routes' maps differ")
    del got, want
    turns = in_turns_ms(runs)
    ms = [sum(t) / 2 for t in turns]
    log(f"{tag} [{card}]: aggregation + WTA + LR at {B}x{H}x{W}x{D} in "
        f"turns: K2 x8 + K3 {' / '.join(f'{x:.3f}' for x in turns[0])} ms, "
        f"batch sweeps {' / '.join(f'{x:.3f}' for x in turns[1])} ms "
        f"({ms[0] / ms[1]:.2f}x); peak memory above C: K2 + K3 "
        f"{peak[0]:.3f} GiB, sweeps {peak[1]:.3f} GiB; maps equal")
    return ms


def check_staged_kernels(lt, rt, params, errs, tag=""):
    """The staged chain's kernels on the (B, H, W) Sobel images lt, rt: the
    fused cost + down pass, K2 on an int16 S (the horizontal and the
    up-going sums) and the three-input WTA/LR (LR on and off), each held
    against its plain version on the same input, frame by frame; with 4 or
    8 paths also wta_lr3 against K3 on the int32 sum of all paths. Raises
    on any difference; returns (C, S_down, S_up, S_h)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    P1, P2 = float(params.P1), float(params.P2)
    sums = {"S_h": [(0, 1), (0, -1)],
            "S_up": plain.up_dirs(params.num_paths)}
    C, S_down = sc.cost_down(lt, rt, params)
    torch.cuda.synchronize()
    S = {k: sc.aggregate_i16(C, params, dirs) for k, dirs in sums.items()}
    torch.cuda.synchronize()
    disp = {}
    for apply_lr in (True, False):
        disp[apply_lr] = sc.wta_lr3(S_down, S["S_up"], S["S_h"], params,
                                    apply_lr)
        torch.cuda.synchronize()
    err = dict.fromkeys(STAGED_CHAIN, 0.0)
    for b in range(lt.shape[0]):
        C_p, Sd_p = plain.cost_down(lt[b], rt[b], params)
        err["cost_down"] = max(err["cost_down"], max_abs_err(C[b], C_p),
                               max_abs_err(S_down[b], Sd_p))
        del Sd_p
        for k, dirs in sums.items():
            S_p = sum(plain.directional_pass(C_p, dy, dx, P1, P2)
                      for dy, dx in dirs)
            err["sgm_pass_i16"] = max(err["sgm_pass_i16"],
                                      max_abs_err(S[k][b], S_p))
            del S_p
        del C_p
        for apply_lr in (True, False):
            err["wta_lr3"] = max(err["wta_lr3"], max_abs_err(
                disp[apply_lr][b],
                plain.wta_lr3(S_down[b], S["S_up"][b], S["S_h"][b], params,
                              apply_lr)))
    if params.num_paths >= 4:
        S32 = sc.aggregate(C, params)
        for apply_lr in (True, False):
            err["wta_lr3"] = max(err["wta_lr3"], max_abs_err(
                disp[apply_lr], sc.wta_lr(S32, params, apply_lr)))
        del S32
    B, H, W, D = C.shape
    log(f"staged kernels {tag}{B}x{H}x{W}x{D}, {params.num_paths} paths, "
        f"min_disparity {params.min_disparity}: max|err| vs plain: "
        + ", ".join(f"{k} {v}" for k, v in err.items())
        + f" (valid {float((disp[True] >= 0).float().mean()):.3f})")
    for k, v in err.items():
        errs[k] = max(errs.get(k, 0.0), v)
    if any(err.values()):
        raise AssertionError(f"a staged-chain kernel differs from its plain "
                             f"version: {err}")
    return C, S_down, S["S_up"], S["S_h"]


def check_transposes(vol, errs, tag):
    """The three transposes on the int16 volume ``vol`` (3-d), on the same
    bits as bfloat16, and on its values widened to int32, against
    permute().contiguous(): bitwise (compared as integers), and there and
    back. Returns the int16 results (vol, leading, dhw order)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    fns = {"transpose_vol": (sc.transpose_vol, plain.transpose_vol, 2),
           "transpose_leading": (sc.transpose_leading,
                                 plain.transpose_leading, 2),
           "transpose_dhw": (sc.transpose_dhw_to_wdh,
                             plain.transpose_dhw_to_wdh, 3)}
    err = dict.fromkeys(fns, 0.0)
    keep = []
    for x in (vol, vol.view(torch.bfloat16), vol.to(torch.int32)):
        bits = torch.int32 if x.element_size() == 4 else torch.int16
        for name, (fn, fn_p, order) in fns.items():
            got = fn(x)
            torch.cuda.synchronize()
            if got.dtype != x.dtype:
                raise AssertionError(f"{name} changed {x.dtype} to "
                                     f"{got.dtype}")
            err[name] = max(err[name], max_abs_err(got.view(bits),
                                                   fn_p(x).view(bits)))
            if x is vol:
                keep.append(got)
            for _ in range(order - 1):     # back to the input's layout
                got = fn(got)
            err[name] = max(err[name], max_abs_err(got.view(bits),
                                                   x.view(bits)))
            del got
    log(f"transposes {tag} {tuple(vol.shape)} int16, bfloat16, int32: "
        "max|err| vs permute().contiguous() and there and back: "
        + ", ".join(f"{k} {v}" for k, v in err.items()))
    for k, v in err.items():
        errs[k] = max(errs.get(k, 0.0), v)
    if any(err.values()):
        raise AssertionError(f"a transpose moved bits wrongly: {err}")
    return keep


def check_speckle(disp, max_diff, max_size, errs, tag):
    """K4 and K5 on the (B, H, W) disparity against their plain versions,
    bitwise; returns (labels, kept)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    labels = sc.speckle_labels(disp, max_diff)
    torch.cuda.synchronize()
    kept = sc.speckle_keep(disp, labels, max_size)
    torch.cuda.synchronize()
    e_lab = max_abs_err(labels, plain.speckle_labels(disp, max_diff))
    e_keep = max_abs_err(kept, plain.speckle_keep(disp, labels, max_size))
    log(f"speckle {tag} {tuple(disp.shape)}: max|err| vs plain: labels "
        f"{e_lab}, keep {e_keep} (valid in "
        f"{float((disp >= 0).float().mean()):.3f}, kept "
        f"{float((kept >= 0).float().mean()):.3f})")
    errs["speckle_labels"] = max(errs.get("speckle_labels", 0.0), e_lab)
    errs["speckle_keep"] = max(errs.get("speckle_keep", 0.0), e_keep)
    if e_lab or e_keep:
        raise AssertionError(f"speckle kernels differ from their plain "
                             f"versions ({tag}): labels {e_lab}, keep "
                             f"{e_keep}")
    return labels, kept


def speckle_split(card, disp, max_diff, max_size, reps=5):
    """ms per sub-launch of K4 and K5 on ``disp``: each sub-launch alone
    through speckle.cu's part entries, CUDA events between them, the mean
    of ``reps`` runs after a warm-up. A timing mode of this script only:
    the wrappers time nothing. The split's labels and output must equal
    the wrappers'."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.utils import kernels
    lib = kernels.load()
    B, H, W = disp.shape
    labels = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    sizes = torch.empty((B, H * W + 1), dtype=torch.int32, device=disp.device)
    out = torch.empty_like(disp)
    calls = {
        "speckle_labels": lambda k: lib.sdr_speckle_labels_part(
            disp.data_ptr(), labels.data_ptr(), B, H, W, float(max_diff), k,
            kernels.stream()),
        "speckle_keep": lambda k: lib.sdr_speckle_keep_part(
            disp.data_ptr(), labels.data_ptr(), sizes.data_ptr(),
            out.data_ptr(), B, H, W, int(max_size), k, kernels.stream())}
    split = {}
    for name, parts in SPECKLE_PARTS.items():
        ms = [0.0] * len(parts)
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(parts) + 1)]
            ev[0].record()
            for k in range(len(parts)):
                kernels.check(calls[name](k), f"{name} part {k}")
                ev[k + 1].record()
            torch.cuda.synchronize()
            for k in range(len(parts)):
                ms[k] += ev[k].elapsed_time(ev[k + 1]) / reps if rep else 0.0
        split[name] = dict(zip(parts, ms))
    want = sc.speckle_labels(disp, max_diff)
    if not (torch.equal(labels, want) and torch.equal(
            out, sc.speckle_keep(disp, want, max_size))):
        raise AssertionError("the speckle split's output differs from the "
                             "wrappers'")
    log(f"speckle split [{card}] {tuple(disp.shape)}, ms per sub-launch: "
        + "; ".join(f"{name} " + ", ".join(f"{p} {t:.4f}"
                                           for p, t in parts.items())
                    for name, parts in split.items()))
    return split


def check_wls(dl, dr, guide, max_disp, errs, tag):
    """K7 and K6 (each of the six passes, on the same input as its plain
    version) against their plain versions, bitwise; returns the kernels'
    (filtered, confidence)."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import wls as plain
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    rhs = wc.shift_gather_conf(dl, dr, max_disp)
    torch.cuda.synchronize()
    e_sg = max_abs_err(rhs, plain.shift_gather_conf(dl, dr, max_disp))
    u, e_fgs = rhs, 0.0
    for lam in plain.fgs_lambdas(8000.0, 3):
        for axis in (-1, -2):
            got = wc.fgs_pass(u, guide, lam, 1.1, axis)
            torch.cuda.synchronize()
            e_fgs = max(e_fgs, max_abs_err(
                got, plain.fgs_pass(u, guide, lam, 1.1, axis)))
            u = got
    log(f"wls {tag} {tuple(dl.shape)}: max|err| vs plain: shift_gather "
        f"{e_sg}, fgs_pass {e_fgs} (conf {float(rhs[:, 1].mean()):.3f})")
    errs["shift_gather"] = max(errs.get("shift_gather", 0.0), e_sg)
    errs["fgs_pass"] = max(errs.get("fgs_pass", 0.0), e_fgs)
    if e_sg or e_fgs:
        raise AssertionError(f"WLS kernels off their plain versions ({tag}):"
                             f" shift_gather {e_sg}, fgs_pass {e_fgs}")
    return plain.filtered_disparity(u), rhs[:, 1]


def fgs_by_batch(card, errs, rhs, guide, reps=20):
    """K6 on the full path's WLS inputs at batch one and at batch eight,
    each axis at each of the filter's lambdas against its plain version,
    bitwise; each axis timed with CUDA events at the first lambda beside
    its bound and its plain version's time, with the plan it took."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import wls as plain
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    for B in (1, 8):
        u, g = rhs[:B].contiguous(), guide[:B].contiguous()
        px = B * g.shape[1] * g.shape[2]
        for axis, name in ((-1, "rows"), (-2, "columns")):
            err = 0.0
            wc.reset_fgs_plans()
            for lam in plain.fgs_lambdas(8000.0, 3):
                got = wc.fgs_pass(u, g, lam, 1.1, axis)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(
                    got, plain.fgs_pass(u, g, lam, 1.1, axis)))
            plan = [k for k, v in wc.FGS_PLANS.items() if v]
            lam = plain.fgs_lambdas(8000.0, 3)[0]
            ms = cuda_ms(lambda: wc.fgs_pass(u, g, lam, 1.1, axis), reps)
            plain_ms = cuda_ms(lambda: plain.fgs_pass(u, g, lam, 1.1, axis),
                               1)
            bms, by = bound(20 * px, 23 * px)
            log(f"fgs_pass [{card}] batch {B} {tuple(g.shape[1:])} {name}: "
                f"kernel {ms:.4f} ms ({'/'.join(plan)}), plain "
                f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}) per launch; "
                f"max|err| vs plain {err} over the three lambdas")
            errs["fgs_pass"] = max(errs.get("fgs_pass", 0.0), err)
            if err:
                raise AssertionError(f"K6 off its plain version at batch {B}"
                                     f", {name}: {err}")


def _noisy_disp(B, H, W, seed):
    """Integer disparities 0..4 with a quarter invalid (many small
    components) and one flat block (a large one)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, (B, H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.25] = -1.0
    d[:, H // 4:H // 2, W // 4:W // 2] = 7.0
    return d


def _banded_pair(B, H, W, seed):
    """Left/right disparities of bands 4..40 seen from both views, with
    noise and invalid pixels; and a random guide image."""
    rng = np.random.default_rng(seed)
    base = 4.0 + 2.0 * ((np.arange(H) * 18) // H)[None, :, None]
    dl = np.float32(base + rng.normal(0, 0.4, (B, H, W)))
    dl[rng.uniform(size=dl.shape) < 0.2] = -1.0
    dr = np.float32(base + rng.normal(0, 0.6, (B, H, W)))
    dr[rng.uniform(size=dr.shape) < 0.1] = -1.0
    guide = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    return dl, dr, guide


def serpentine(H, W, pitch=2):
    """Boustrophedon snake: one 1-px-wide connected path over the image
    with H / (2 pitch) double turns, the worst case for sweep CCLs."""
    disp = -np.ones((H, W), np.float32)
    for r in range(0, H, 2 * pitch):
        disp[r, :] = 5.0
        if r + 2 * pitch < H:
            disp[r:r + 2 * pitch + 1,
                 W - 1 if (r // (2 * pitch)) % 2 == 0 else 0] = 5.0
    return disp


def phase_kernels(errs):
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops.sgbm import sobel_clip
    for H, W, D in KERNEL_SHAPES:
        params = SGBMParams(num_disparities=D, block_size=5,
                            speckle_window_size=0)
        left, right = _pair(H, W, D // 3, seed=H)
        lt = sobel_clip(torch.tensor(left, device=DEVICE), 63)
        rt = sobel_clip(torch.tensor(right, device=DEVICE), 63)
        check_kernels(lt, rt, params, errs)
        for num_paths in (8, 4, 2):
            for md in (0, 3):
                C = check_staged_kernels(lt, rt, SGBMParams(
                    num_disparities=D, block_size=5, speckle_window_size=0,
                    num_paths=num_paths, min_disparity=md), errs)[0]
        check_transposes(C[0], errs, "(H, W, D)")
        del C
        torch.cuda.empty_cache()
    for H, W in ((32, 48), (96, 160)):
        d = torch.tensor(_noisy_disp(2, H, W, seed=H), device=DEVICE)
        for max_size in (4, 40):
            check_speckle(d, 1.0, max_size, errs, f"noisy max {max_size}")
        dl, dr, guide = (torch.tensor(a, device=DEVICE)
                         for a in _banded_pair(2, H, W, seed=W))
        check_wls(dl, dr, guide, 48, errs, "banded")
    snake = serpentine(*SERPENTINE)
    d = torch.tensor(np.stack([snake, snake[::-1, ::-1].copy()]),
                     device=DEVICE)
    labels, kept = check_speckle(d, 1.0, 200, errs, "serpentine")
    n_comp = [int(torch.unique(labels[b][d[b] >= 0]).numel())
              for b in range(2)]
    log(f"serpentine: components per frame {n_comp}, "
        f"{int((d[0] >= 0).sum())} px each")
    if n_comp != [1, 1] or not torch.equal(kept, d):
        raise AssertionError(f"the serpentine is not one kept component: "
                             f"{n_comp}")


def phase_matcher():
    import torch
    from stereo_depth_ruler_tpu_torch.io.synthetic import (
        make_scene, render_stereo_pair)
    from stereo_depth_ruler_tpu_torch.ops.sgbm_ref import sgbm_numpy
    from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
    from stereo_depth_ruler_tpu_torch.ops.sgbm_cuda import sgbm_cuda
    rig = StereoRig.synthetic(width=48, height=32, focal=50.0,
                              baseline_mm=30.0)
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 400.0),
                       background_z_mm=700.0, seed=1)
    left, right, _ = render_stereo_pair(scene, seed=1)
    for num_paths, speckle in ((2, 0), (4, 0), (8, 0), (8, 20)):
        params = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                            speckle_window_size=speckle, speckle_range=2,
                            num_paths=num_paths)
        ref = sgbm_numpy(left, right, params)
        got = sgbm_cuda(torch.tensor(np.float32(left[None]), device=DEVICE),
                        torch.tensor(np.float32(right[None]), device=DEVICE),
                        params)[0].cpu().numpy()
        torch.cuda.synchronize()
        n_bad = int((got != ref).sum())
        log(f"matcher vs sgbm_numpy, 32x48x16, {num_paths} paths, speckle "
            f"window {speckle}: {n_bad} differing pixels, valid "
            f"{(got >= 0).mean():.3f}")
        if n_bad:
            raise AssertionError("sgbm_cuda differs from sgbm_numpy")


def render_frames(B, H, W):
    """bench.py's scene: 5 boxes, seed 0, frame i shifted 2i px."""
    from stereo_depth_ruler_tpu_torch import StereoRig
    from stereo_depth_ruler_tpu_torch.io.synthetic import (
        make_scene, render_stereo_pair)
    t0 = time.perf_counter()
    rig = StereoRig.synthetic(width=W, height=H)
    scene = make_scene(rig, n_boxes=5, z_range_mm=(900.0, 4000.0),
                       background_z_mm=6000.0, seed=0)
    frames = [render_stereo_pair(scene, seed=0, shift=(2.0 * i, 0.0))
              for i in range(B)]
    log(f"main path: {B} frames {W}x{H} rendered in "
        f"{time.perf_counter() - t0:.1f} s")
    return (rig, np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]),
            np.stack([f[2] for f in frames]))


def drive(pipe, lefts, rights, counters):
    """One counted run: every launch count set to 0 just before, read just
    after; then the run's peak memory and ms per batch over 5 repeats."""
    import torch
    pipe.process_batch(lefts, rights)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launch_counts()
    out = pipe.process_batch(lefts, rights)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pipe.process_batch(lefts, rights)
    end.record()
    torch.cuda.synchronize()
    return out, launches, peak, start.elapsed_time(end) / reps


def check_output(out, gts, D, tag):
    """Shapes and finiteness; returns (valid fraction, MAE) against the
    ground truth outside the left D columns (no partner there)."""
    B, H, W = gts.shape
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    expect = {"disparity": (B, H, W), "xyz": (B, 3, H, W),
              "confidence": (B, H, W), "left_rectified": (B, H, W),
              "right_rectified": (B, H, W), "frame_stats": (B, 3)}
    if shapes != expect:
        raise AssertionError(f"output shapes {shapes} != {expect}")
    if not np.isfinite(out["frame_stats"][:, :2].cpu().numpy()).all():
        raise AssertionError("non-finite stats")
    return accuracy(out["disparity"], gts, D, tag)


def accuracy(disp, gts, D, tag):
    """(valid fraction, MAE) of finite (B, H, W) disparity maps against the
    ground truth outside the left D columns (no partner there)."""
    disp = disp.cpu().numpy()
    if not np.isfinite(disp).all():
        raise AssertionError("non-finite disparity")
    d, g = disp[..., D:], gts[..., D:]
    ok = d >= 0
    vfrac = float(ok.mean())
    mae = float(np.abs(d[ok] - g[ok]).mean())
    log(f"{tag} accuracy (outside the left {D} columns): valid "
        f"{vfrac:.4f}, MAE {mae:.4f} px")
    return vfrac, mae


def phase_main_path(card, errs, frames):
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    rig, lefts, rights, gts = frames
    B, H, W = lefts.shape
    D = MAIN[3]
    cfg = PipelineConfig(
        sgbm=SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=0),
        downscale=1, use_wls=False, lr_mode="fast", remap_precision="u8")
    pipe = StereoPipeline(rig, cfg, rectify=True, device=DEVICE)
    out, launches, peak, batch_ms = drive(pipe, lefts, rights, [sc])
    log(f"main path launches: {launches}")
    if ({k for k, v in launches.items() if v} != {"cost_box", *AGG}
            or any(launches[k] != 1 for k in ("cost_box", *AGG))):
        raise AssertionError(f"the main path did not launch K1 and the "
                             f"batch sweeps once each, and nothing else: "
                             f"{launches}")
    vfrac, mae = check_output(out, gts, D, "main path (bar valid >= 0.9, "
                              "MAE <= 0.5)")
    if not (vfrac >= 0.9 and mae <= 0.5):
        raise AssertionError(f"accuracy bar missed: valid {vfrac}, "
                             f"MAE {mae}")
    log(f"main path [{card}]: batch {B} in {batch_ms:.2f} ms -> "
        f"{B * 1000.0 / batch_ms:.2f} frames/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated)")

    # the kernels at the main path's shapes, on its own matcher inputs
    # (downscale 1: the rectified frames), against their plain versions;
    # these launches come after the counts above were read
    params = cfg.sgbm
    lt = plain.sobel_clip(out["left_rectified"], params.pre_filter_cap)
    rt = plain.sobel_clip(out["right_rectified"], params.pre_filter_cap)
    C, S = check_kernels(lt, rt, params, errs)
    if not torch.equal(sc.wta_lr(S, params), out["disparity"]):
        raise AssertionError("the kernels' disparity differs from the "
                             "pipeline's")
    C_p = plain.cost_volume(lt, rt, params)
    S_p = plain.aggregate_paths(C_p, params.P1, params.P2, 8)
    n_dirs = len(params.path_dirs)
    times = {   # ms per launch at batch 8; sgm_pass: mean over directions
        "cost_box": (cuda_ms(lambda: sc.cost_volume(lt, rt, params), 3),
                     cuda_ms(lambda: plain.cost_volume(lt, rt, params), 1),
                     None),
        "sgm_pass": (cuda_ms(lambda: sc.aggregate(C, params), 2) / n_dirs,
                     cuda_ms(lambda: plain.aggregate_paths(
                         C_p, params.P1, params.P2, 8), 1) / n_dirs, None),
        "wta_lr": (cuda_ms(lambda: sc.wta_lr(S, params), 3),
                   cuda_ms(lambda: plain.wta_lr(S_p, params), 1), None),
    }
    px, el = B * H * W, B * H * W * D
    # bytes: each input read once, each output written once; operations
    # per volume element: K1 ~14 (1.1 BT evaluations of 9 operations, the
    # sliding row sum and the ring's vertical update), K2 ~8
    # (four-way min, add, subtract), K3 ~4 (packed key, min, uniqueness)
    bounds = {
        "cost_box": bound(2 * 4 * px + 2 * el, 14 * el),
        # one storing pass (C in, S out: 6 B per element) and seven
        # accumulating ones (C and S in, S out: 10 B), per launch
        "sgm_pass": bound((6 + 7 * 10) / n_dirs * el, 8 * el),
        "wta_lr": bound(4 * el + 4 * px, 4 * el),
    }
    for name, (ms, plain_ms, _) in times.items():
        log(f"main path [{card}]: {name} at {B}x{H}x{W}x{D}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bounds[name][0]:.3f} ms ({bounds[name][1]}) per launch")
    del S, C_p, S_p
    torch.cuda.empty_cache()

    # the batch route's kernels on the same volume, against their plain
    # stages, and the two routes in turns at batch 8 and at batch 1
    agg_times, agg_bounds = check_agg(card, C, params, errs, B, "main path")
    times.update(agg_times)
    bounds.update(agg_bounds)
    route_turns(card, C, params, B, f"main path batch {B}")
    route_turns(card, C[:1].contiguous(), params, 1, "main path batch 1")
    del C
    torch.cuda.empty_cache()

    # K2 and K3's own counted run: the matcher with fused_wta=False on the
    # path's rectified frames launches K1, K2 x8 and K3 and nothing else,
    # and gives the path's map
    lrect, rrect = out["left_rectified"], out["right_rectified"]
    sc.reset_launch_counts()
    dpass = sc.sgbm_cuda(lrect, rrect, params, fused_wta=False)
    torch.cuda.synchronize()
    passes = dict(sc.LAUNCHES)
    log(f"K2 + K3 route (fused_wta=False) launches: {passes}")
    if ({k: v for k, v in passes.items() if v}
            != {"cost_box": 1, **PASSES}):
        raise AssertionError(f"sgbm_cuda(fused_wta=False) did not launch "
                             f"K1, K2 x8 and K3 alone: {passes}")
    if not torch.equal(dpass, out["disparity"]):
        raise AssertionError("the K2 + K3 route's map differs from the "
                             "path's")
    del dpass
    return times, bounds, (lrect, rrect, out["disparity"], params), passes


def phase_staged_chain(card, errs, rect):
    """The staged matcher chain on the slice-1 path's rectified frames
    (``rect``: left, right, the path's disparity, its parameters): a counted
    run of sgbm_staged_cuda; its map against sgbm_cuda's and the path's;
    cost_down against K1 and three K2 passes; the chain's kernels against
    their plain versions on the full batch; times, bounds, the two chains
    in turns and their peak memory. Then a counted run of the stage
    profiler, which launches the transposes, and the transposes on one
    frame's volume at the profiler's shapes, checked and timed."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    left, right, disp_path, params = rect
    B, H, W = left.shape
    D = params.num_disparities

    def counted(fn):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sc.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(sc.LAUNCHES), torch.cuda.max_memory_allocated()

    disp, launches, peak = counted(
        lambda: sc.sgbm_staged_cuda(left, right, params))
    log(f"staged chain launches: {launches}")
    if {k: v for k, v in launches.items() if v} != STAGED_CHAIN:
        raise AssertionError(f"the staged chain's kernels did not run as "
                             f"expected: {launches}")
    fused, _, peak_fused = counted(lambda: sc.sgbm_cuda(left, right, params))
    if not (torch.equal(disp, fused) and torch.equal(disp, disp_path)):
        raise AssertionError("sgbm_staged_cuda differs from sgbm_cuda or "
                             "from the slice-1 path")
    log(f"staged chain: sgbm_staged_cuda's map equal to sgbm_cuda's and to "
        f"the slice-1 path's on {B} frames (valid "
        f"{float((disp >= 0).float().mean()):.4f})")
    del disp, fused

    cap = params.pre_filter_cap
    lt = plain.sobel_clip(left, cap).contiguous()
    rt = plain.sobel_clip(right, cap).contiguous()
    C, S_down, S_up, S_h = check_staged_kernels(lt, rt, params, errs,
                                                "on the main path's inputs ")
    S32 = torch.empty(C.shape, dtype=torch.int32, device=C.device)
    down = plain.down_dirs(params.num_paths)
    for i, (dy, dx) in enumerate(down):
        sc.sgm_pass(C, S32, dy, dx, params.P1, params.P2, i > 0)
    if not (torch.equal(C, sc.cost_volume(lt, rt, params))
            and torch.equal(S_down.int(), S32)):
        raise AssertionError("cost_down differs from K1 or from K2's "
                             "down-going passes")
    log(f"staged chain: cost_down's C equal to K1's and its sum to "
        f"{len(down)} K2 passes")
    del S32

    ab = in_turns_ms([lambda: sc.sgbm_cuda(left, right, params),
                      lambda: sc.sgbm_staged_cuda(left, right, params)])
    for chain, t, pk in zip(("fused", "staged"), ab, (peak_fused, peak)):
        ms = sum(t) / len(t)
        log(f"A/B [{card}]: matcher alone, batch {B}, {chain} chain: "
            f"{ms:.3f} ms per call (turns {', '.join(f'{x:.3f}' for x in t)})"
            f", peak memory {pk / 2**30:.2f} GiB")
    # one frame pair: the latency a single pair pays in each chain
    l1, r1 = left[:1].contiguous(), right[:1].contiguous()
    if not torch.equal(sc.sgbm_staged_cuda(l1, r1, params),
                       sc.sgbm_cuda(l1, r1, params)):
        raise AssertionError("sgbm_staged_cuda differs from sgbm_cuda at "
                             "batch 1")
    ab = in_turns_ms([lambda: sc.sgbm_cuda(l1, r1, params),
                      lambda: sc.sgbm_staged_cuda(l1, r1, params)])
    for chain, t in zip(("fused", "staged"), ab):
        log(f"A/B [{card}]: matcher alone, batch 1, {chain} chain: "
            f"{sum(t) / len(t):.3f} ms per call (turns "
            f"{', '.join(f'{x:.3f}' for x in t)}); maps equal")
    log(f"staged chain [{card}]: cost_down at 1x{H}x{W}x{D}: "
        f"{cuda_ms(lambda: sc.cost_down(lt[:1], rt[:1], params), 3):.3f} ms")
    # twice the batch: as many frames as the full path stacks (left and
    # right), more than are resident at once
    l2, r2 = torch.cat([lt, lt]), torch.cat([rt, rt])
    log(f"staged chain [{card}]: cost_down at {2 * B}x{H}x{W}x{D}: "
        f"{cuda_ms(lambda: sc.cost_down(l2, r2, params), 3):.3f} ms")
    del l2, r2

    P1, P2 = float(params.P1), float(params.P2)
    sums = ([(0, 1), (0, -1)], plain.up_dirs(params.num_paths))
    n_i16 = sum(len(d) for d in sums)
    C_p = C.float()
    times = {
        "cost_down": (cuda_ms(lambda: sc.cost_down(lt, rt, params), 3),
                      cuda_ms(lambda: plain.cost_down(lt, rt, params), 1),
                      None),
        "sgm_pass_i16": (
            cuda_ms(lambda: [sc.aggregate_i16(C, params, d) for d in sums],
                    2) / n_i16,
            cuda_ms(lambda: [plain.directional_pass(C_p, dy, dx, P1, P2)
                             for d in sums for dy, dx in d], 1) / n_i16,
            None),
        "wta_lr3": (
            cuda_ms(lambda: sc.wta_lr3(S_down, S_up, S_h, params), 3),
            cuda_ms(lambda: plain.wta_lr3(S_down, S_up, S_h, params), 1),
            None),
    }
    del C_p, S_down, S_up, S_h
    px, el = B * H * W, B * H * W * D
    # cost_down: the two images in, two int16 volumes out; K1's ~14
    # operations per element and ~8 per path update. K2 on an int16 S: a
    # storing pass moves 4 B per element, an accumulating one 6; the mean
    # over the chain's passes. wta_lr3: three int16 volumes in, the map out
    n_store = len(sums)
    bounds = {
        "cost_down": bound(2 * 4 * px + 2 * 2 * el, (14 + 8 * len(down)) * el),
        "sgm_pass_i16": bound((4 * n_store + 6 * (n_i16 - n_store)) / n_i16
                              * el, 8 * el),
        "wta_lr3": bound(3 * 2 * el + 4 * px, 6 * el),
    }
    for name, (ms, plain_ms, _) in times.items():
        log(f"staged chain [{card}]: {name} at {B}x{H}x{W}x{D}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bounds[name][0]:.3f} ms ({bounds[name][1]}) per launch")

    # the transposes: the stage profiler is the entry point that runs them
    sys.path.insert(0, str(ROOT / "tools"))
    import profile_stages_torch
    torch.cuda.synchronize()
    sc.reset_launch_counts()
    report = profile_stages_torch.run(DEVICE, H, W, D, batch=1, reps=3,
                                      out=sys.stdout)
    torch.cuda.synchronize()
    launches.update({k: sc.LAUNCHES[k] for k in TRANSPOSES})
    log(f"stage profiler [{card}]: launches {dict(sc.LAUNCHES)}; sums of "
        f"stages {report['chain_ms']}")
    if min(launches[k] for k in TRANSPOSES) < 1:
        raise AssertionError(f"a transpose was not launched: {launches}")
    Cd = C[0].permute(2, 0, 1).contiguous()        # (D, H, W)
    del C
    torch.cuda.empty_cache()
    Cw = check_transposes(Cd, errs, "(D, H, W)")[2]    # (W, D, H)
    # the profiler's three: (D,H,W) -> (W,D,H), that back to (H,D,W), and
    # (D,H,W) -> (H,D,W); the plain version is the library call itself
    for name, fn, fn_p, x in (
            ("transpose_dhw", sc.transpose_dhw_to_wdh,
             plain.transpose_dhw_to_wdh, Cd),
            ("transpose_vol", sc.transpose_vol, plain.transpose_vol, Cw),
            ("transpose_leading", sc.transpose_leading,
             plain.transpose_leading, Cd)):
        lib_ms = cuda_ms(lambda: fn_p(x), 5)
        times[name] = (cuda_ms(lambda: fn(x), 5), lib_ms, lib_ms)
        bounds[name] = bound(2 * x.numel() * x.element_size(), 0)
        log(f"transposes [{card}]: {name} {tuple(x.shape)} int16: kernel "
            f"{times[name][0]:.3f} ms, permute().contiguous() {lib_ms:.3f} "
            f"ms, bound {bounds[name][0]:.3f} ms ({bounds[name][1]})")
    return launches, times, bounds


def phase_full_path(card, errs, frames):
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.ops import wls as wplain
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    rig, lefts, rights, gts = frames
    B, H, W = lefts.shape
    D = MAIN[3]
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    cfg = PipelineConfig(sgbm=params, downscale=1, use_wls=True,
                         lr_mode="right_matcher", remap_precision="u8")
    pipe = StereoPipeline(rig, cfg, rectify=True, device=DEVICE)
    out, launches, peak, batch_ms = drive(pipe, lefts, rights, [sc, wc])
    log(f"full path launches: {launches}")
    if {k for k, v in launches.items() if v} != FULL_PATH:
        raise AssertionError(f"the full path's kernels did not run as "
                             f"expected: {launches}")
    vfrac, mae = check_output(out, gts, D, "full path (bar valid > 0.95, "
                              "MAE < 0.7)")
    if not (vfrac > 0.95 and mae < 0.7):
        raise AssertionError(f"WLS accuracy bar missed: valid {vfrac}, "
                             f"MAE {mae}")
    log(f"full path [{card}]: batch {B} in {batch_ms:.2f} ms -> "
        f"{B * 1000.0 / batch_ms:.2f} frames/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated)")

    # K1-K7 on the path's own inputs: K1-K3 on the 2B stacked frames
    # (right view mirrored and swapped), K4/K5 on their matcher outputs
    # before the speckle filter, then K6/K7 on the WLS inputs
    lrect, rrect = out["left_rectified"], out["right_rectified"]
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(torch.cat([lrect, rrect.flip(-1)]), cap)
    rt = plain.sobel_clip(torch.cat([rrect, lrect.flip(-1)]), cap)
    C, S = check_kernels(lt, rt, params, errs)
    del lt, rt
    dm = sc.wta_lr(S, params)
    del S
    torch.cuda.empty_cache()
    # the two matcher routes in turns on the stacked frames
    route_turns(card, C, params, 2 * B, f"full path, {2 * B} stacked frames")
    del C
    torch.cuda.empty_cache()
    r, ws = params.speckle_range, params.speckle_window_size
    labels, kept = check_speckle(dm, r, ws, errs, "full path")
    dl, dr = kept[:B], kept[B:].flip(-1).contiguous()
    filtered, conf = check_wls(dl, dr, lrect, D, errs, "full path")
    if not (torch.equal(filtered, out["disparity"])
            and torch.equal(conf, out["confidence"])):
        raise AssertionError("the kernels' WLS output differs from the "
                             "pipeline's")
    rhs = wc.shift_gather_conf(dl, dr, D)
    # the library figures: K7's gather alone, K5's histogram alone
    lab64 = labels.reshape(2 * B, -1).to(torch.int64)
    ones = torch.ones_like(lab64, dtype=torch.int32)
    sizes = torch.zeros((2 * B, H * W + 1), dtype=torch.int32,
                        device=dl.device)
    xs = torch.arange(W, dtype=torch.float32, device=dl.device)
    idx = torch.round(xs - dl).clamp(0, W - 1).to(torch.int64)
    n = 2 * len(wplain.fgs_lambdas(8000.0, 3))
    times = {
        "speckle_labels": (cuda_ms(lambda: sc.speckle_labels(dm, r), 5),
                           cuda_ms(lambda: plain.speckle_labels(dm, r), 1),
                           None),
        "speckle_keep": (cuda_ms(lambda: sc.speckle_keep(dm, labels, ws), 5),
                         cuda_ms(lambda: plain.speckle_keep(dm, labels, ws),
                                 1),
                         cuda_ms(lambda: sizes.scatter_add_(1, lab64, ones),
                                 5)),
        "shift_gather": (None,
                         cuda_ms(lambda: wplain.shift_gather_conf(dl, dr, D),
                                 2),
                         None),
        "fgs_pass": (cuda_ms(lambda: wc.fgs_filter_cuda(rhs, lrect), 3) / n,
                     cuda_ms(lambda: wplain.fgs_filter(rhs, lrect), 1) / n,
                     None),
    }
    # K7 and torch.gather (the gather alone) in turns, 20 calls a turn
    k7, gather = in_turns_ms([lambda: wc.shift_gather_conf(dl, dr, D),
                              lambda: torch.gather(dr, -1, idx)], reps=20)
    log(f"full path [{card}]: shift_gather in turns with torch.gather: "
        f"K7 {' / '.join(f'{x:.4f}' for x in k7)} ms, torch.gather "
        f"{' / '.join(f'{x:.4f}' for x in gather)} ms")
    times["shift_gather"] = (sum(k7) / 2, times["shift_gather"][1],
                             sum(gather) / 2)
    px2, px = 2 * B * H * W, B * H * W
    # K6 per pixel and launch, counted from the Thomas solve (once per
    # element, as the kernel computes it): the weight 4 (subtract, abs,
    # divide, exp), the coefficients 4, the elimination 11 (den 2, the
    # reciprocal, c' 2, each of the two d' 3) and back substitution 4
    bounds = {
        "speckle_labels": bound(8 * px2, 4 * px2),
        "speckle_keep": bound(12 * px2, 3 * px2),
        "shift_gather": bound(16 * px, 10 * px),
        "fgs_pass": bound(20 * px, 23 * px),
    }
    library = {"shift_gather": "torch.gather, the gather alone",
               "speckle_keep": "scatter_add_, the histogram alone"}
    for name, (ms, plain_ms, lib_ms) in times.items():
        lib = f", {library[name]} {lib_ms:.3f} ms" if lib_ms else ""
        log(f"full path [{card}]: {name}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms{lib}, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}) per launch")
    speckle_split(card, dm, r, ws)
    fgs_by_batch(card, errs, rhs, lrect)
    # the outputs go to the host, so that the shared path's peak memory
    # is its own; the matcher maps and their labels feed the sort family
    return launches, times, bounds, (pipe, {k: v.cpu() for k, v in
                                            out.items()}, peak), (dm, labels)


def phase_sort_family(card, errs, maps, r, ws):
    """The sort family's entry points on the full path's 16 matcher maps
    before the speckle filter (``maps``: the maps and their K4 labels, 16 x
    2^20 sort keys per call), range ``r`` and window ``ws``: one counted
    run of the capped speckle_filter, the seeded keep and
    equal_value_counts; then each new kernel and mode against its plain
    version, bitwise, on those maps and the 720x1280 serpentine; the sweep
    run to convergence against K4; then times and bounds."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.ops import sort as splain
    from stereo_depth_ruler_tpu_torch.ops import sort_cuda as soc
    dm, labels = maps
    B, H, W = dm.shape
    torch.cuda.synchronize()
    sc.reset_launch_counts()
    soc.reset_launch_counts()
    kept = sc.speckle_filter(dm, ws, r, max_iters=3)
    seeded = sc.speckle_keep_seeded(labels, ws)
    counts = soc.equal_value_counts(labels)
    torch.cuda.synchronize()
    launches = {**sc.LAUNCHES, **soc.LAUNCHES}
    log(f"sort family launches: {launches}")
    if {k for k, v in launches.items() if v} != set(SORT_FAMILY):
        raise AssertionError(f"the sort family's kernels did not run as "
                             f"expected: {launches}")

    snake = serpentine(*SERPENTINE)
    ds = torch.tensor(np.stack([snake, snake[::-1, ::-1].copy()]),
                      device=DEVICE)
    ls = sc.speckle_labels(ds, 1.0)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    err = dict.fromkeys(SORT_FAMILY, 0.0)

    def hold(name, got, want):
        err[name] = max(err[name], max_abs_err(got, want))

    seeds = []   # sparse random seeds, one in a thousand pixels
    for d, lab, md in ((dm, labels, r), (ds, ls, 1.0)):
        for k in (1, 2, 3):
            hold("sweep_labels", sc.sweep_labels(d, md, k),
                 plain.speckle_labels(d, md, k))
        hold("sweep_labels", sc.sweep_labels(d, md), lab)   # K4's
        seeds.append((torch.rand(lab.shape, generator=g, device=DEVICE)
                      < 1e-3).to(torch.int32))
        for k in (2, 0):
            hold("sweep_propagate", sc.propagate_keep(lab, seeds[-1], k),
                 plain.propagate_keep(lab, seeds[-1], k))
    key, n, n2, L, R = splain.pack_batched(labels)
    skey = soc.sort_keys(key)
    hold("radix_sort_keys", skey,
         torch.sort(key.reshape(B, -1), stable=True).values.reshape(key.shape))
    val = torch.randint(0, 2 ** 31 - 1, key.shape, generator=g,
                        device=DEVICE, dtype=torch.int32)
    pos = splain.positions(key)
    for v in (val, pos):
        got = soc.sort_pairs(key, v)
        want, idx = torch.sort(key.reshape(B, -1), stable=True)
        hold("radix_sort_pairs", got[0], want.reshape(key.shape))
        hold("radix_sort_pairs", got[1], torch.gather(
            v.reshape(B, -1), 1, idx).reshape(key.shape))
    sidx = got[1]
    # the labels unpadded (all below 2^20): the top digit is the same in
    # every key, and the sort skips its pass
    flat = labels.reshape(B, -1).contiguous()
    want, idx = torch.sort(flat, stable=True)
    pos_flat = splain.positions(flat)
    hold("radix_sort_keys", soc.sort_keys(flat), want)
    got = soc.sort_pairs(flat, pos_flat)
    hold("radix_sort_pairs", got[0], want)
    hold("radix_sort_pairs", got[1], torch.gather(pos_flat, 1, idx))
    del want, idx, got
    hold("sorted_runs_sizes", counts, splain.equal_value_counts(labels))
    hold("sorted_runs_keep", kept, plain.speckle_filter(dm, dm >= 0, ws, r, 3))
    # the three run modes on the maps' labels and on the serpentine's (one
    # component over most of each frame: runs across many tiles)
    for lab in (labels, ls):
        k, nl, n2l, Ll, _ = splain.pack_batched(lab)
        sk, si = soc.sort_pairs(k, splain.positions(k))
        hold("sorted_runs_sizes", soc.run_sizes(sk), splain.run_sizes(sk))
        hold("sorted_runs_sizes", soc.run_sizes(sk, si, nl),
             splain.run_sizes(sk, si, nl))
        hold("sorted_runs_keep", soc.run_keep(sk, si, nl, ws),
             splain.run_keep(sk, si, nl, ws))
        hold("sorted_runs_keep", soc.speckle_keep_sorted(lab, ws),
             splain.speckle_keep_sorted(lab, ws))
        hold("sorted_runs_roots", soc.large_run_roots(sk, n2l, Ll, ws),
             splain.large_run_roots(sk, n2l, Ll, ws))
    # all keys distinct: no run crosses a tile edge (the split below)
    distinct = splain.positions(key)
    hold("sorted_runs_sizes", soc.run_sizes(distinct, sidx, n),
         splain.run_sizes(distinct, sidx, n))
    hold("sweep_propagate", seeded, plain.speckle_keep_seeded(labels, ws))
    # on converged labels the seeded keep is K5's keep of the valid pixels
    hold("sweep_propagate", seeded, sc.speckle_keep(dm, labels, ws) >= 0)
    torch.cuda.synchronize()
    log(f"sort family {B}x{H}x{W} and the serpentine: max|err| vs plain: "
        + ", ".join(f"{k} {v}" for k, v in err.items())
        + f" (capped filter keeps {float(kept.float().mean()):.4f}, seeded "
        f"{float(seeded.float().mean()):.4f})")
    for k, v in err.items():
        errs[k] = v
    if any(err.values()):
        raise AssertionError(f"a sort-family kernel differs from its plain "
                             f"version: {err}")

    key2 = key.reshape(B, -1)
    times = {   # (kernel, plain, library) ms per call
        "sweep_labels": (cuda_ms(lambda: sc.sweep_labels(dm, r, 3), 5),
                         cuda_ms(lambda: plain.speckle_labels(dm, r, 3), 1),
                         None),
        "sweep_propagate": (
            cuda_ms(lambda: sc.propagate_keep(labels, seeds[0]), 5),
            cuda_ms(lambda: plain.propagate_keep(labels, seeds[0]), 1), None),
        "radix_sort_keys": (
            cuda_ms(lambda: soc.sort_keys(key), 5),
            cuda_ms(lambda: splain.sort_keys(key), 5),
            cuda_ms(lambda: torch.sort(key2, stable=True), 5)),
        "radix_sort_pairs": (
            cuda_ms(lambda: soc.sort_pairs(key, pos), 5),
            cuda_ms(lambda: splain.sort_pairs(key, pos), 5),
            cuda_ms(lambda: torch.sort(key2, stable=True), 5)),
        "sorted_runs_sizes": (
            cuda_ms(lambda: soc.run_sizes(skey, sidx, n), 5),
            cuda_ms(lambda: splain.run_sizes(skey, sidx, n), 5), None),
        "sorted_runs_keep": (
            cuda_ms(lambda: soc.run_keep(skey, sidx, n, ws), 5),
            cuda_ms(lambda: splain.run_keep(skey, sidx, n, ws), 5), None),
        "sorted_runs_roots": (
            cuda_ms(lambda: soc.large_run_roots(skey, n2, L, ws), 5),
            cuda_ms(lambda: splain.large_run_roots(skey, n2, L, ws), 5),
            None),
    }
    px, keys = B * H * W, B * n2
    slots = splain.roots_slots(L, ws)
    # the rounds these maps need: the timed labels call stops at 3, the
    # propagation runs to convergence
    full = sc.sweep_labels(dm, r)
    rounds_lab = next(k for k in (1, 2, 3) if k == 3 or torch.equal(
        sc.sweep_labels(dm, r, k), full))
    full = sc.propagate_keep(labels, seeds[0])
    rounds_prop = next(k for k in range(1, 1 << 20) if torch.equal(
        sc.propagate_keep(labels, seeds[0], k), full))
    log(f"sort family: rounds needed: labels {rounds_lab} (capped at 3), "
        f"propagation {rounds_prop}")
    # converged, the host reads the change flags after every round; capped
    # at the same number of rounds it never waits: the difference is what
    # the reads cost
    conv, capped = in_turns_ms([
        lambda: sc.propagate_keep(labels, seeds[0]),
        lambda: sc.propagate_keep(labels, seeds[0], rounds_prop)])
    conv, capped = sum(conv) / 2, sum(capped) / 2
    log(f"sort family [{card}]: sweep_propagate converged {conv:.4f} ms, "
        f"capped at its {rounds_prop} rounds {capped:.4f} ms: the host's "
        f"flag reads cost {(conv - capped) / rounds_prop:.4f} ms per round")
    # bytes: each input read once, each output written once. Operations:
    # the sweep ~6 per pixel, sweep and round; the sort ~4 per key and
    # pass; the run scans ~8 per key (the head test, its ballot, the bit
    # scans for the run's ends, the size)
    bounds = {
        "sweep_labels": bound(8 * px, 6 * 4 * rounds_lab * px),
        "sweep_propagate": bound(12 * px, 6 * 4 * rounds_prop * px),
        "radix_sort_keys": bound(8 * keys, 16 * keys),
        "radix_sort_pairs": bound(16 * keys, 16 * keys),
        "sorted_runs_sizes": bound(8 * keys + 4 * B * n, 8 * keys),
        "sorted_runs_keep": bound(8 * keys + B * n, 8 * keys),
        "sorted_runs_roots": bound(4 * keys + 4 * B * R * slots, 4 * keys),
    }
    # the sizes kernel three ways: (a) the real keys and source indices,
    # (b) no source indices (coalesced stores), (c) all keys distinct (no
    # run crosses a tile edge); (a) - (b) is the scatter's cost, (a) - (c)
    # the tile-edge searches'
    split = [cuda_ms(lambda: soc.run_sizes(skey, sidx, n), 10),
             cuda_ms(lambda: soc.run_sizes(skey), 10),
             cuda_ms(lambda: soc.run_sizes(distinct, sidx, n), 10)]
    log(f"sort family [{card}]: sorted_runs_sizes split at {B}x{n2} keys: "
        f"(a) keys and sidx {split[0]:.4f} ms, (b) no sidx {split[1]:.4f} "
        f"ms (bound {bound(8 * keys, 0)[0]:.4f}), (c) distinct keys "
        f"{split[2]:.4f} ms: scatter {split[0] - split[1]:.4f} ms, edge "
        f"searches {split[0] - split[2]:.4f} ms")
    log(f"sort family [{card}]: radix sort of {B}x{n2} unpadded labels "
        f"(top pass skipped): keys {cuda_ms(lambda: soc.sort_keys(flat), 5):.3f} ms, pairs "
        f"{cuda_ms(lambda: soc.sort_pairs(flat, pos_flat), 5):.3f} ms, "
        f"torch.sort(stable=True) "
        f"{cuda_ms(lambda: torch.sort(flat, stable=True), 5):.3f} ms")
    log(f"sort family [{card}]: the capped speckle_filter (3 rounds) at "
        f"{B}x{H}x{W}: "
        f"{cuda_ms(lambda: sc.speckle_filter(dm, ws, r, max_iters=3), 5):.3f}"
        f" ms per call")
    for name, (ms, plain_ms, lib_ms) in times.items():
        lib = (f", torch.sort(stable=True) {lib_ms:.3f} ms"
               if lib_ms is not None else "")
        log(f"sort family [{card}]: {name} at {B}x{H}x{W} ({B}x{n2} keys): "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}) per call")
    return launches, times, bounds


def in_turns_ms(fns, reps=5):
    """ms per call of the two functions, timed in the turns a, b, b, a (each
    turn a warm-up call, then ``reps`` calls between CUDA events); returns
    each one's two turns."""
    turns = ([], [])
    for i in (0, 1, 1, 0):
        turns[i].append(cuda_ms(fns[i], reps))
    return turns


def phase_shared_path(card, errs, frames, stacked):
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    rig, lefts, rights, gts = frames
    B, H, W = lefts.shape
    D = MAIN[3]
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    cfg = PipelineConfig(sgbm=params, downscale=1, use_wls=True,
                         lr_mode="right_matcher", pair_mode="shared",
                         remap_precision="u8")
    pipe = StereoPipeline(rig, cfg, rectify=True, device=DEVICE)
    out, launches, peak, _ = drive(pipe, lefts, rights, [sc, wc])
    log(f"shared path launches: {launches}")
    if ({k for k, v in launches.items() if v}
            != FULL_PATH - {"cost_box", "agg_up_wta"} | set(PAIR_MODES)):
        raise AssertionError(f"the shared path's kernels did not run as "
                             f"expected: {launches}")
    vfrac, mae = check_output(out, gts, D, "shared path (bar valid > 0.95, "
                              "MAE < 0.7)")
    if not (vfrac > 0.95 and mae < 0.7):
        raise AssertionError(f"WLS accuracy bar missed: valid {vfrac}, "
                             f"MAE {mae}")
    s_pipe, s_out, s_peak = stacked
    differ = [k for k in s_out if not torch.equal(out[k].cpu(), s_out[k])]
    if differ:
        raise AssertionError(f"shared and stacked pipelines differ in {differ}")
    log(f"shared path: every output equal to the stacked path's "
        f"({sorted(s_out)})")

    # the A/B, in turns stacked, shared, shared, stacked
    ab = {f"batch {B}": in_turns_ms([
              lambda: s_pipe.process_batch(lefts, rights),
              lambda: pipe.process_batch(lefts, rights)]),
          "process_pair": in_turns_ms([
              lambda: s_pipe.process_pair(lefts[0], rights[0]),
              lambda: pipe.process_pair(lefts[0], rights[0])])}
    for tag, turns in ab.items():
        n = 1 if tag == "process_pair" else B
        for mode, t in zip(("stacked", "shared"), turns):
            ms = sum(t) / len(t)
            log(f"A/B [{card}]: {tag}, {mode}: {ms:.3f} ms per call "
                f"(turns {', '.join(f'{x:.3f}' for x in t)}) -> "
                f"{n * 1000.0 / ms:.2f} frames/s")
    log(f"A/B [{card}]: peak memory at batch {B}: stacked "
        f"{s_peak / 2**30:.2f} GiB, shared {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated)")

    # K1's pair mode, K2 and K3's mirror mode on the path's own inputs, frame
    # by frame against their plain versions
    lrect, rrect = out["left_rectified"], out["right_rectified"]
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(lrect, cap)
    rt = plain.sobel_clip(rrect, cap)
    C = sc.cost_volume_pair(lt, rt, params)
    torch.cuda.synchronize()
    S = sc.aggregate(C, params)
    torch.cuda.synchronize()
    disp = {}
    for apply_lr in (True, False):
        disp[apply_lr] = sc.wta_lr(S, params, apply_lr, mirror_from=B)
        torch.cuda.synchronize()
    err = {"cost_box_pair": 0.0, "sgm_pass": 0.0, "wta_lr_mirror": 0.0}
    for b in range(B):
        vols = plain.cost_volume_pair(lt[b], rt[b], params)
        for i, C_p in ((b, vols[0]), (B + b, vols[1])):
            err["cost_box_pair"] = max(err["cost_box_pair"],
                                       max_abs_err(C[i], C_p))
            S_p = plain.aggregate_paths(C_p, params.P1, params.P2,
                                        params.num_paths)
            err["sgm_pass"] = max(err["sgm_pass"], max_abs_err(S[i], S_p))
            for apply_lr in (True, False):
                err["wta_lr_mirror"] = max(err["wta_lr_mirror"], max_abs_err(
                    disp[apply_lr][i],
                    plain.wta_lr(S_p, params, apply_lr, mirror_lr=i >= B)))
            del S_p
        del vols
    log(f"shared path kernels {2 * B}x{H}x{W}x{D}: max|err| vs plain: "
        + ", ".join(f"{k} {v}" for k, v in err.items())
        + f" (valid {float((disp[True] >= 0).float().mean()):.3f})")
    for k, v in err.items():
        errs[k] = max(errs.get(k, 0.0), v)
    if any(err.values()):
        raise AssertionError(f"a pair mode differs from its plain version: "
                             f"{err}")

    S_f = S.float()
    times = {"wta_lr_mirror": (
        cuda_ms(lambda: sc.wta_lr(S, params, mirror_from=B), 3),
        cuda_ms(lambda: (plain.wta_lr(S_f[:B], params),
                         plain.wta_lr(S_f[B:], params, mirror_lr=True)), 1),
        None)}
    del S, S_f
    torch.cuda.empty_cache()
    # the batch route in mirror mode on the same volume: its kernels against
    # their plain stages, its map equal to K3's mirror mode, and the two
    # routes in turns
    agg_times, agg_bounds = check_agg(card, C, params, errs, B,
                                      "shared path")
    if not torch.equal(sc.aggregate_wta(C, params, mirror_from=B),
                       disp[True]):
        raise AssertionError("the batch route's mirror mode differs from "
                             "K3's")
    del disp
    times["agg_up_wta_mirror"] = agg_times["agg_up_wta_mirror"]
    route_turns(card, C, params, B, f"shared path, {2 * B} pair frames")
    torch.cuda.empty_cache()
    times["cost_box_pair"] = (
        cuda_ms(lambda: sc.cost_volume_pair(lt, rt, params), 3),
        cuda_ms(lambda: plain.cost_volume_pair(lt, rt, params), 1), None)
    del C
    torch.cuda.empty_cache()
    px, el = B * H * W, B * H * W * D
    # K1 pair: the two images read, both volumes written; ~14 operations per
    # C_L element as K1 (C_R is the same sums, stored again). K3 mirror: K3's
    # bytes and operations on the 2B frames
    bounds = {"cost_box_pair": bound(2 * 4 * px + 2 * 2 * el, 14 * el),
              "wta_lr_mirror": bound(2 * (4 * el + 4 * px), 2 * 4 * el),
              "agg_up_wta_mirror": agg_bounds["agg_up_wta_mirror"]}
    for name, (ms, plain_ms, _) in times.items():
        log(f"shared path [{card}]: {name} at {B}x{H}x{W}x{D}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bounds[name][0]:.3f} ms ({bounds[name][1]}) per launch")

    # the matcher's two maps against the stacked matcher's
    dl, dr = sc.sgbm_pair_cuda(lrect, rrect, params)
    dd = sc.sgbm_cuda(torch.cat([lrect, rrect.flip(-1)]),
                      torch.cat([rrect, lrect.flip(-1)]), params)
    torch.cuda.synchronize()
    if not (torch.equal(dl, dd[:B]) and torch.equal(dr, dd[B:].flip(-1))):
        raise AssertionError("sgbm_pair_cuda differs from the stacked pair")
    log(f"shared path: sgbm_pair_cuda's (disp_l, disp_r) equal to the "
        f"stacked matcher's on {B} frames")
    # K2 and K3's mirror mode in their own counted run: the shared pair
    # with fused_wta=False, equal to the batch route's maps
    sc.reset_launch_counts()
    pl, pr = sc.sgbm_pair_cuda(lrect, rrect, params, fused_wta=False)
    torch.cuda.synchronize()
    passes = dict(sc.LAUNCHES)
    log(f"shared pair, K2 + K3 route (fused_wta=False) launches: {passes}")
    if ({k: v for k, v in passes.items() if v}
            != {"cost_box_pair": 1, "sgm_pass": 8, "wta_lr_mirror": 1,
                "speckle_labels": 1, "speckle_keep": 1}):
        raise AssertionError(f"sgbm_pair_cuda(fused_wta=False) did not "
                             f"launch K1's pair mode, K2 x8, K3's mirror "
                             f"mode, K4 and K5 alone: {passes}")
    if not (torch.equal(pl, dl) and torch.equal(pr, dr)):
        raise AssertionError("the shared pair's two routes differ")
    launches["wta_lr_mirror"] = passes["wta_lr_mirror"]
    return launches, times, bounds, pipe


def check_pair(card, lt, rt, params, errs):
    """K1's pair mode on the (1, H, W) Sobel images against its plain
    version, bitwise, and timed."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    C = sc.cost_volume_pair(lt, rt, params)
    torch.cuda.synchronize()
    C_L, C_R = plain.cost_volume_pair(lt, rt, params)
    e = max(max_abs_err(C[:1], C_L), max_abs_err(C[1:], C_R))
    del C_L, C_R
    errs["cost_box_pair"] = max(errs["cost_box_pair"], e)
    ms = cuda_ms(lambda: sc.cost_volume_pair(lt, rt, params), 3)
    _, H, W = lt.shape
    log(f"configs [{card}]: K1 pair block {params.block_size} at "
        f"1x{H}x{W}x{params.num_disparities}: max|err| vs plain {e}, "
        f"kernel {ms:.3f} ms")
    del C
    if e:
        raise AssertionError(f"K1's pair mode differs from plain at block "
                             f"{params.block_size}, {H}x{W}")


def phase_configs(card, errs, frames):
    """Configurations the three paths do not run, each held to its plain
    version: K1 and its pair mode at blocks 1, 3, 7, 9 and 11 on one
    720x1280x128 frame (timed); StereoPipeline at the reference's own defaults (downscale 2,
    80 disparities, speckle 200/2, right matcher, WLS) on BGR frames with
    remap_precision="f32", and with lr_mode="none" and no WLS, each output
    against the plain chain on the pipeline's rectified frames; then the
    stress shape 2560x1440x256 on one frame: K1-K3, the batch route's
    kernels and K1's pair mode (timed) against plain, the two matcher
    routes in turns, the fused and the staged matcher (speckle
    200/2) agreeing, and K4/K5 on the matcher's map before the filter
    against plain (timed)."""
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.ops import wls as wplain
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    from stereo_depth_ruler_tpu_torch.pipeline import (
        PipelineConfig, StereoPipeline, downscale2x)
    H, W, D = KERNEL_SHAPES[-1]
    left, right = _pair(H, W, D // 3, seed=11)
    lt = plain.sobel_clip(torch.tensor(left, device=DEVICE), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=DEVICE), 63)
    for block in (1, 3, 7, 9, 11):
        params = SGBMParams(num_disparities=D, block_size=block,
                            speckle_window_size=0)
        C = sc.cost_volume(lt, rt, params)
        torch.cuda.synchronize()
        e = max_abs_err(C, plain.cost_volume(lt, rt, params))
        errs["cost_box"] = max(errs["cost_box"], e)
        ms = cuda_ms(lambda: sc.cost_volume(lt, rt, params), 5)
        log(f"configs [{card}]: K1 block {block} at 1x{H}x{W}x{D}: max|err| "
            f"vs plain {e}, kernel {ms:.3f} ms")
        if e:
            raise AssertionError(f"K1 differs from plain at block {block}")
        del C
        check_pair(card, lt, rt, params, errs)
    torch.cuda.empty_cache()

    rig, lefts, rights, _ = frames
    n, (H, W) = 2, lefts.shape[1:]

    def bgr(x):   # uint8 BGR frames whose channels differ
        x = x[:n].astype(np.float32)
        return np.clip(np.stack([0.8 * x, x, 1.1 * x + 3.0], axis=-1), 0,
                       255).astype(np.uint8)

    for tag, cfg in (
            ("reference defaults, BGR, f32 remap",
             PipelineConfig(remap_precision="f32")),
            ("downscale 2, BGR, lr_mode none, no WLS",
             PipelineConfig(use_wls=False, lr_mode="none"))):
        pipe = StereoPipeline(rig, cfg, rectify=True, device=DEVICE)
        out, launches, _, batch_ms = drive(pipe, bgr(lefts), bgr(rights),
                                           [sc, wc])
        params = cfg.sgbm
        left = downscale2x(out["left_rectified"])
        right = downscale2x(out["right_rectified"])
        if cfg.use_wls:
            dl, dr = plain.compute_disparity_pair(left, right, params)
            want, conf = wplain.wls_disparity_filter(
                dl, dr, left,
                max_disp=params.num_disparities + params.min_disparity)
        else:
            want = plain.sgbm(left, right, params, apply_lr=False)
            conf = (want >= 0).to(torch.float32)
        ok = (tuple(out["disparity"].shape) == (n, H // 2, W // 2)
              and torch.equal(out["disparity"], want)
              and torch.equal(out["confidence"], conf)
              and bool(torch.isfinite(out["disparity"]).all()))
        ran = sorted(k for k, v in launches.items() if v)
        log(f"configs [{card}]: pipeline, {tag}: {n} frames "
            f"{W}x{H} -> {tuple(out['disparity'].shape)}, equal to the plain "
            f"chain: {ok}, valid {float((want >= 0).float().mean()):.4f}, "
            f"{batch_ms:.2f} ms per batch; kernels {ran}")
        # without the LR check the batch route has no LR pass
        expect = FULL_PATH if cfg.use_wls else FULL_PATH - {
            "fgs_pass", "shift_gather", "agg_lr"}
        if not ok or set(ran) != expect:
            raise AssertionError(f"the pipeline ({tag}) differs from its "
                                 f"plain chain, or ran {ran}")
        del pipe, out, want, conf
    torch.cuda.empty_cache()

    H, W, D = STRESS
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=0)
    left, right = _pair(H, W, 77, seed=5)
    lt = plain.sobel_clip(torch.tensor(left, device=DEVICE), 63)
    rt = plain.sobel_clip(torch.tensor(right, device=DEVICE), 63)
    C, S = check_kernels(lt, rt, params, errs)
    del S
    torch.cuda.empty_cache()
    check_agg(card, C, params, errs, 1, "stress")
    route_turns(card, C, params, 1, "stress")
    del C
    torch.cuda.empty_cache()
    check_pair(card, lt, rt, params, errs)
    torch.cuda.empty_cache()
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    l, r = torch.tensor(left, device=DEVICE), torch.tensor(right,
                                                           device=DEVICE)
    fused = sc.sgbm_cuda(l, r, params)
    staged = sc.sgbm_staged_cuda(l, r, params)
    torch.cuda.synchronize()
    ms = (cuda_ms(lambda: sc.sgbm_cuda(l, r, params), 2),
          cuda_ms(lambda: sc.sgbm_staged_cuda(l, r, params), 2))
    log(f"configs [{card}]: stress 1x{H}x{W}x{D}, speckle 200/2: fused and "
        f"staged maps equal: {torch.equal(fused, staged)} (valid "
        f"{float((fused >= 0).float().mean()):.4f}); fused {ms[0]:.3f} ms, "
        f"staged {ms[1]:.3f} ms per frame")
    if not torch.equal(fused, staged):
        raise AssertionError("the fused and the staged chain differ at the "
                             "stress shape")
    del fused, staged
    # K4 and K5 on the stress frame's matcher map before the filter
    raw = sc.sgbm_cuda(l, r, params, apply_speckle=False)
    md, ws = params.speckle_range, params.speckle_window_size
    labels, _ = check_speckle(raw, md, ws, errs, "stress")
    ms = (cuda_ms(lambda: sc.speckle_labels(raw, md), 5),
          cuda_ms(lambda: sc.speckle_keep(raw, labels, ws), 5))
    log(f"configs [{card}]: stress 1x{H}x{W}: speckle_labels {ms[0]:.4f} "
        f"ms, speckle_keep {ms[1]:.4f} ms per launch")
    del raw, labels
    torch.cuda.empty_cache()


def _slab(C, start, local, top, bottom):
    """Rows [start - top, start + local + bottom) of a (1, H, W, D) volume,
    zero rows where they lie outside it."""
    import torch
    H = C.shape[1]
    z = torch.zeros_like(C[:, :1])
    rows = [C[:, max(start - top, 0):min(start + local + bottom, H)]]
    rows = ([z.expand(-1, max(top - start, 0), -1, -1)] + rows
            + [z.expand(-1, max(start + local + bottom - H, 0), -1, -1)])
    return torch.cat(rows, dim=1).contiguous()


def phase_sharded(card, errs, frames, full_pipe):
    """The sharded path (stereo_depth_ruler_tpu_torch/parallel) on a world
    of one NCCL rank and the mesh (1, 1, 1), and the tile matcher (K9) in
    this process at 2 and 4 tiles: (1) sgbm_sharded on one bench frame,
    equal to sgbm_cuda, launching K1, K9 (the batch route's four
    kernels on the slab), K4 and K5 once each; (2)
    pipeline_step_sharded at batch 8 with rects and WLS, equal frame by
    frame to the composition of the port's own functions (remap,
    sgbm_cuda on the pair and on the mirrored, swapped pair, the WLS
    filter, reproject), launching K1, K9, K6 and K7 only,
    at the WLS bar, timed in turns with the full path; (3) 2 tiles with a
    full-coverage halo equal to the whole frame, halo 64 at 2 and 4 tiles
    within the halo-32 bound of the JAX package's HALO_r04.jsonl (max
    |err| <= 1/16 px, exact fraction >= 0.9999), sgbm_tile_cuda against
    plain.sgbm_tile and the int32 route on slabs with halos of 0, 8 and
    64 (zero rows beyond the image included), the batch route's kernels
    on the slabs against their plain stages, the two routes timed in
    turns; (4) per tile at 720x1280x128 and 2560x1440x256 for 1, 2 and 4
    tiles, the two routes in turns on the tile's slab, ms and peak memory
    per tile.
    Returns the counted step's launches and K9's times and bounds."""
    import tempfile

    import torch
    import torch.distributed as dist
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    from stereo_depth_ruler_tpu_torch.ops.remap import (build_remap_grids,
                                                        remap_bilinear)
    from stereo_depth_ruler_tpu_torch.ops.reproject import reproject_to_3d
    from stereo_depth_ruler_tpu_torch.parallel import (
        make_mesh, pipeline_step_sharded, sgbm_sharded)
    from stereo_depth_ruler_tpu_torch.parallel.sharded import (
        _sgbm_cuda_tile, _tile_halo, _tile_slab)
    rig, lefts, rights, gts = frames
    B, H, W = lefts.shape
    D = MAIN[3]
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    l0 = torch.tensor(np.float32(lefts[0]), device=DEVICE)
    r0 = torch.tensor(np.float32(rights[0]), device=DEVICE)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(1, 1, 1)
            log(f"sharded: a world of 1 ({dist.get_backend()}), mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
            # (1) the matcher on the mesh
            sgbm_sharded(l0, r0, params, mesh)
            torch.cuda.synchronize()
            sc.reset_launch_counts()
            got = sgbm_sharded(l0, r0, params, mesh)
            torch.cuda.synchronize()
            ran = {k: v for k, v in sc.LAUNCHES.items() if v}
            want = sc.sgbm_cuda(l0[None], r0[None], params)[0]
            log(f"sharded: sgbm_sharded 1x{H}x{W}x{D}, speckle 200/2, "
                f"launches {ran}; equal to sgbm_cuda: "
                f"{torch.equal(got, want)} (valid "
                f"{float((want >= 0).float().mean()):.4f})")
            if not torch.equal(got, want):
                raise AssertionError("sgbm_sharded differs from sgbm_cuda")
            if ran != {"cost_box": 1, "sgbm_tile": 1, "speckle_labels": 1,
                       "speckle_keep": 1, **{k: 1 for k in AGG}}:
                raise AssertionError(f"sgbm_sharded ran {ran}")

            # (2) the pipeline step at batch 8, full width
            grids = build_remap_grids(rig, DEVICE)

            def step():
                return pipeline_step_sharded(lefts, rights, rig.Q, params,
                                             mesh, rects=grids, use_wls=True)

            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sc.reset_launch_counts()
            wc.reset_launch_counts()
            out = step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = {**sc.LAUNCHES, **wc.LAUNCHES}
            log(f"sharded step launches: {launches}")
            # per frame two K9 (the pair and the mirrored, swapped pair),
            # each K1 and the batch route's four kernels; one K7, six K6
            step_kernels = {"cost_box": 2 * B, "sgbm_tile": 2 * B,
                            "shift_gather": B, "fgs_pass": 6 * B,
                            **{k: 2 * B for k in AGG}}
            if {k: v for k, v in launches.items() if v} != step_kernels:
                raise AssertionError(f"the sharded step ran {launches}")
            turns = in_turns_ms([step,
                                 lambda: full_pipe.process_batch(lefts,
                                                                 rights)],
                                reps=3)
        finally:
            dist.destroy_process_group()

    disp, xyz = out["disparity"], out["xyz"]
    same = True
    for i in range(B):
        l = remap_bilinear(torch.tensor(np.float32(lefts[i]), device=DEVICE),
                           grids[0])
        r = remap_bilinear(torch.tensor(np.float32(rights[i]),
                                        device=DEVICE), grids[1])
        dl = sc.sgbm_cuda(l[None], r[None], params, apply_speckle=False)
        dr = sc.sgbm_cuda(r.flip(-1)[None].contiguous(),
                          l.flip(-1)[None].contiguous(), params,
                          apply_speckle=False).flip(-1).contiguous()
        f, _ = wc.wls_disparity_filter_cuda(dl, dr, l[None], max_disp=D)
        x = reproject_to_3d(f[0], rig.Q)
        same &= bool(torch.equal(disp[i], f[0])) and bool(
            ((xyz[i] == x) | (xyz[i].isnan() & x.isnan())).all())
    log(f"sharded step: {B}x{H}x{W}x{D}, rects, WLS: disparity and xyz "
        f"equal to the frame-by-frame composition: {same}")
    if not same:
        raise AssertionError("pipeline_step_sharded differs from the "
                             "composition of the port's functions")
    vfrac, mae = accuracy(disp, gts, D, "sharded step (bar valid > 0.95, "
                          "MAE < 0.7)")
    if not (vfrac > 0.95 and mae < 0.7):
        raise AssertionError(f"WLS accuracy bar missed: valid {vfrac}, "
                             f"MAE {mae}")
    for tag, t in zip(("sharded step", "full path (StereoPipeline)"), turns):
        ms = sum(t) / len(t)
        log(f"sharded [{card}]: batch {B}, {tag}: {ms:.3f} ms per batch "
            f"(turns {', '.join(f'{x:.3f}' for x in t)}) -> "
            f"{B * 1000.0 / ms:.2f} frames/s")
    log(f"sharded [{card}]: step peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated, frames matched one at a time)")
    del out, disp, xyz
    torch.cuda.empty_cache()

    # (3) K9 in this process, tile by tile, on the bench frame
    flat = SGBMParams(num_disparities=D, block_size=5, speckle_window_size=0)
    whole = sc.sgbm_cuda(l0[None], r0[None], flat)[0]
    for n_tile, halo in ((2, H // 2), (2, 64), (4, 64)):
        h = H // n_tile
        tiles = torch.cat([_sgbm_cuda_tile(l0, r0, flat, k, n_tile, h, halo)
                           for k in range(n_tile)])
        torch.cuda.synchronize()
        both = (tiles >= 0) & (whole >= 0)
        diff = (tiles - whole).abs()[both]
        exact = float((tiles == whole).double().mean())
        err = float(diff.max()) if diff.numel() else 0.0
        flips = int(((tiles >= 0) != (whole >= 0)).sum())
        log(f"sharded K9 [{card}]: {n_tile} tiles of {h} rows, halo {halo} "
            f"(rounded {_tile_halo(n_tile, h, halo)}): "
            f"exact fraction {exact:.7f} (of both-valid pixels "
            f"{float((diff == 0).double().mean()):.7f}), max|err| {err} px, "
            f"validity flips {flips}")
        if halo >= h and not torch.equal(tiles, whole):
            raise AssertionError("K9 with a full-coverage halo differs from "
                                 "the whole frame")
        if exact < 0.9999 or err > 1.0 / 16:
            raise AssertionError(f"K9 halo {halo} at {n_tile} tiles past the "
                                 f"bound: exact {exact}, max|err| {err}")
    cap = flat.pre_filter_cap
    C_full = sc.cost_volume(plain.sobel_clip(l0[None], cap).contiguous(),
                            plain.sobel_clip(r0[None], cap).contiguous(),
                            flat)
    bias = sc.tile_bias(flat)
    err = 0.0
    tile_errs = dict.fromkeys(AGG, 0.0)
    q = H // 4
    for start, local, top, bottom in ((0, H, 0, 0), (0, q, 64, 64),
                                      (q, 2 * q, 8, 64), (3 * q, q, 64, 8),
                                      (2 * q, q, 0, 8), (0, 2 * q, 8, 0)):
        C = _slab(C_full, start, local, top, bottom)
        for apply_lr in (True, False):
            got = sc.sgbm_tile_cuda(C, flat, top, bottom, apply_lr)
            torch.cuda.synchronize()
            e = max(max_abs_err(got, plain.sgbm_tile(C, flat, top, bottom,
                                                     apply_lr)),
                    max_abs_err(got, sc._sgbm_tile_i32(C, flat, top,
                                                       apply_lr)[:, :local]))
            err = max(err, e)
        # the batch route's kernels on the slab against their plain stages
        body = C[:, top:]
        S = sc.agg_down(C, flat, bias, top)
        S_p = plain.tile_down_sum(C, flat, top, bias)
        tile_errs["agg_down"] = max(tile_errs["agg_down"],
                                    max_abs_err(S, S_p))
        sc.agg_horiz(body, S, flat)
        S_p = plain.tile_horizontal(body, S_p, flat)
        tile_errs["agg_horiz"] = max(tile_errs["agg_horiz"],
                                     max_abs_err(S, S_p))
        del S_p
        out, d2p = sc._agg_up(body, S, flat, bias, True, 1, local)
        want = plain.tile_up_wta(body, S, flat, bias, False)[:, :local]
        tile_errs["agg_up_wta"] = max(tile_errs["agg_up_wta"],
                                      max_abs_err(out, want))
        sc._agg_lr(out, d2p, flat, 1)
        want = plain.tile_up_wta(body, S, flat, bias, True)[:, :local]
        tile_errs["agg_lr"] = max(tile_errs["agg_lr"],
                                  max_abs_err(out, want))
        torch.cuda.synchronize()
        del S, out, d2p, want
        log(f"sharded K9: slab rows {start}-{start + local} of {H}, halos "
            f"{top}/{bottom}: max|err| vs plain.sgbm_tile and the int32 "
            f"route {e}; stages {tile_errs}")
    errs["sgbm_tile"] = err
    for k, e in tile_errs.items():   # the batch's records: the worse of both
        errs[k] = max(errs.get(k, 0.0), e)
    if err or any(tile_errs.values()):
        raise AssertionError("sgbm_tile_cuda differs from plain.sgbm_tile, "
                             "the int32 route or a plain stage")
    C = C_full
    # the two routes in turns on the whole-frame slab
    k9, i32 = in_turns_ms([lambda: sc.sgbm_tile_cuda(C, flat),
                           lambda: sc._sgbm_tile_i32(C, flat, 0, True)])
    log(f"sharded [{card}]: K9 on the 1x{H}x{W}x{D} slab in turns with the "
        f"int32 route (K2 x8, K3): {' / '.join(f'{x:.3f}' for x in k9)} "
        f"ms against {' / '.join(f'{x:.3f}' for x in i32)} ms")
    S = sc.agg_down(C, flat, bias)
    S_h = S.clone()
    sc.agg_horiz(C, S_h, flat)
    out, d2p = sc._agg_up(C, S_h, flat, bias, True, 1, H)
    S_t = S.clone()
    times = {
        "sgbm_tile": (sum(k9) / 2,
                      cuda_ms(lambda: plain.sgbm_tile(C, flat), 1), None),
        "agg_down": (cuda_ms(lambda: sc.agg_down(C, flat, bias), 10),
                     cuda_ms(lambda: plain.tile_down_sum(C, flat, 0, bias),
                             1), None),
        "agg_horiz": (cuda_ms(lambda: sc.agg_horiz(C, S_t, flat), 10),
                      cuda_ms(lambda: plain.tile_horizontal(C, S, flat), 1),
                      None),
        "agg_up_wta": (
            cuda_ms(lambda: sc._agg_up(C, S_h, flat, bias, True, 1, H), 10),
            cuda_ms(lambda: plain.tile_up_wta(C, S_h, flat, bias, False), 1),
            None),
        "agg_lr": (cuda_ms(lambda: sc._agg_lr(out, d2p, flat, 1), 10),
                   None, None),
    }
    # the LR pass's plain version: lr_check on the 8-path sum and its WTA
    S_f = (S_h.float() + bias + plain._sum_passes(
        C.float(), plain.up_dirs(flat.num_paths), flat))
    disp_f, valid_f = plain.wta(S_f, flat)
    times["agg_lr"] = (times["agg_lr"][0], cuda_ms(
        lambda: plain.lr_check(S_f, disp_f, valid_f, flat), 1), None)
    del S_f, disp_f, valid_f
    el, px = H * W * D, H * W
    # bytes: each input read once, each output written once; operations
    # ~8 per element and path, ~4 per element for the WTA, ~4 per pixel
    # for the LR check
    bounds = {"sgbm_tile": bound(2 * el + 4 * px, (8 * 8 + 4) * el),
              "agg_down": bound(4 * el, 8 * 3 * el),
              "agg_horiz": bound(6 * el, 8 * 2 * el),
              "agg_up_wta": bound(4 * el + 8 * px, (8 * 3 + 4) * el),
              "agg_lr": bound(12 * px, 4 * px)}
    for name in ("sgbm_tile", *AGG):
        log(f"sharded [{card}]: {name} on the step's 1x{H}x{W}x{D} slab: "
            f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.3f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    del C, C_full, whole, S, S_h, S_t, out, d2p
    torch.cuda.empty_cache()

    # (4) per tile, halo 64: the two routes in turns on the tile's slab,
    # then ms and peak memory per tile (slab build + K9) for each
    for Hs, Ws, Ds in (KERNEL_SHAPES[-1], STRESS):
        if (Hs, Ws) == (H, W):
            l, r = l0, r0
        else:
            pl, pr = _pair(Hs, Ws, 77, seed=5)
            l, r = (torch.tensor(a[0], device=DEVICE) for a in (pl, pr))
        p = SGBMParams(num_disparities=Ds, block_size=5,
                       speckle_window_size=0)
        for n_tile in (1, 2, 4):
            h = Hs // n_tile
            k = min(1, n_tile - 1)      # an inner tile where there is one
            Cs, halo = _tile_slab(l, r, p, k, n_tile, h, 64)
            a, b = in_turns_ms([
                lambda: sc.sgbm_tile_cuda(Cs, p, halo, halo),
                lambda: sc._sgbm_tile_i32(Cs, p, halo, True)], reps=3)
            del Cs
            torch.cuda.empty_cache()

            def tile():
                return _sgbm_cuda_tile(l, r, p, k, n_tile, h, 64)

            def tile_i32():
                Cs, halo = _tile_slab(l, r, p, k, n_tile, h, 64)
                return sc._sgbm_tile_i32(Cs, p, halo, True)[0, :h]

            res = []
            for fn in (tile, tile_i32):
                ms = cuda_ms(fn, 3)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                res.append((ms, (torch.cuda.max_memory_allocated() - base)
                            / 2**30))
                torch.cuda.empty_cache()
            M = h + 2 * halo
            log(f"sharded tiles [{card}]: {Ws}x{Hs}x{Ds}, {n_tile} tiles, "
                f"tile {k}: {M}-row slab; K9 alone in turns "
                f"{' / '.join(f'{x:.3f}' for x in a)} ms, int32 route "
                f"{' / '.join(f'{x:.3f}' for x in b)} ms; per tile with the "
                f"slab build {res[0][0]:.3f} ms, peak memory {res[0][1]:.3f} "
                f"GiB (int32 route {res[1][0]:.3f} ms, {res[1][1]:.3f} GiB)")
            if res[0][1] > res[1][1]:
                raise AssertionError("K9's peak memory per tile passes the "
                                     "int32 route's")
        del l, r
        torch.cuda.empty_cache()
    # the kernels' records keep the batch's times; K9's stay in the log
    return (launches, {"sgbm_tile": times["sgbm_tile"]},
            {"sgbm_tile": bounds["sgbm_tile"]})


def _cli(argv):
    """cli.main(argv) with its standard output captured and returned;
    raises where it exits with another code than 0."""
    import contextlib
    import io
    from stereo_depth_ruler_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main([str(a) for a in argv])
    if code != 0:
        raise AssertionError(f"cli {argv[0]} exited {code}")
    return buf.getvalue()


def _counted(fn):
    """fn()'s result and the kernels it launched (sgbm_cuda's and
    wls_cuda's counts, set to 0 just before), the device synchronised."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc
    for c in (sc, wc):
        c.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for c in (sc, wc) for k, v in c.LAUNCHES.items() if v}


def _expect_launches(tag, launches, per_call, calls):
    """Raise unless ``launches`` are ``per_call`` times ``calls``."""
    want = {k: v * calls for k, v in per_call.items()}
    log(f"{tag}: launches {launches} in {calls} calls")
    if launches != want:
        raise AssertionError(f"{tag} launched {launches}, want {want}")


def host_run(card, video, rig, cfg, n_frames, tmp, tag):
    """The CLI's run on ``video``, its launches counted, its per-frame
    metrics held bitwise to StereoPipeline.process_batch on the same
    VideoSource batches; logs video_end_to_end_fps beside the
    process_batch loop's frames/s and the upload's ms per batch."""
    import torch
    from stereo_depth_ruler_tpu_torch.io.video import VideoSource
    from stereo_depth_ruler_tpu_torch.pipeline import StereoPipeline
    _, H, W, D = HOST
    metrics = Path(tmp) / f"{tag}.jsonl"
    text, launches = _counted(lambda: _cli(
        ["run", video, "--batch", HOST_BATCH, "--num-disp", D, "--width", W,
         "--height", H, "--metrics", metrics, "--device", DEVICE]))
    _expect_launches(f"host run {tag}", launches, FULL_PATH_PER_BATCH,
                     -(-n_frames // HOST_BATCH))
    summary = json.loads(text.strip().splitlines()[-1])
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    if [r["frame_index"] for r in recs] != list(range(n_frames)):
        raise AssertionError(f"cli run wrote frames "
                             f"{[r['frame_index'] for r in recs]}")

    # the same frames through process_batch: per-frame stats bitwise, the
    # loop's frames/s, and the upload alone
    pipe = StereoPipeline(rig, cfg, device=DEVICE)
    src = VideoSource(video)
    batches = list(src.batches(HOST_BATCH))
    pipe.process_batch(batches[0][1], batches[0][2])     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = [(idxs, pipe.process_batch(lefts, rights)["frame_stats"])
             for idxs, lefts, rights in batches]
    torch.cuda.synchronize()
    loop_fps = n_frames / (time.perf_counter() - t0)
    for idxs, st in stats:
        st = st.cpu().numpy()
        for k, fi in enumerate(idxs):
            if fi < 0:
                continue
            r = recs[fi]
            got = (r["valid_disparity_frac"], r["depth_coverage"],
                   r["mean_depth_mm"])
            if got != tuple(float(v) for v in st[k]):
                raise AssertionError(f"cli run frame {fi}: {got} != "
                                     f"process_batch {st[k]}")
    up = []
    for _, lefts, rights in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.as_tensor(lefts).to(DEVICE)
        torch.as_tensor(rights).to(DEVICE)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t1) * 1e3)
    log(f"host run {tag} [{card}]: video_end_to_end_fps "
        f"{summary['video_end_to_end_fps']} (cli, {n_frames} frames, batch "
        f"{HOST_BATCH}, decode + upload + matcher + WLS + stats); "
        f"process_batch loop {loop_fps:.2f} frames/s; upload "
        f"{np.mean(up):.3f} ms per batch ({batches[0][1].dtype} "
        f"{tuple(batches[0][1].shape)} x 2, pageable); metrics equal "
        f"bitwise on {n_frames} frames; valid "
        f"{summary['valid_disparity_frac']:.4f}")


def phase_host(card):
    """The CLI and the cloud on the card: synth, run (counted, metrics
    equal to process_batch), cloud (disparity equal to the plain matcher,
    voxels equal to the CPU's), measure (equal to measure_distance)."""
    import tempfile

    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
    from stereo_depth_ruler_tpu_torch.cloud import (CloudConfig,
                                                    PointCloudGenerator)
    from stereo_depth_ruler_tpu_torch.io.pcd import read_pcd, write_pcd
    from stereo_depth_ruler_tpu_torch.io.video import (VideoSource,
                                                       read_sbsv, write_sbsv)
    from stereo_depth_ruler_tpu_torch.measure import measure_distance
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops.voxel import voxel_downsample
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    from stereo_depth_ruler_tpu_torch.utils import native
    n_frames, H, W, D = HOST
    rig = StereoRig.synthetic(width=W, height=H)
    # the CLI's configuration: _sgbm_params keeps SGBMParams' speckle
    # 200/2, right matcher and WLS, u8 remap, downscale 1
    params = SGBMParams(num_disparities=D, block_size=5, num_paths=8)
    cfg = PipelineConfig(sgbm=params, downscale=1, use_wls=True,
                         lr_mode="right_matcher")
    frame = 3
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gray = Path(tmp) / "gray.sbsv"
        t0 = time.perf_counter()
        _cli(["synth", "--out", gray, "--gt-out", Path(tmp) / "gt.npy",
              "--width", W, "--height", H, "--frames", n_frames,
              "--seed", 0])
        f = read_sbsv(gray)
        bgr_frames = np.empty(f.shape + (3,), np.uint8)
        for i in range(0, n_frames, HOST_BATCH):
            g = f[i:i + HOST_BATCH].astype(np.float32)
            bgr_frames[i:i + HOST_BATCH] = np.stack(
                [g, 0.5 * g + 64.0, 0.8 * g], axis=-1).astype(np.uint8)
        bgr = Path(tmp) / "bgr.sbsv"
        write_sbsv(bgr, bgr_frames)
        del f, bgr_frames
        log(f"host: synth {n_frames} frames {W}x{H} and the BGR copy in "
            f"{time.perf_counter() - t0:.1f} s")
        host_run(card, gray, rig, cfg, n_frames, tmp, "gray")
        host_run(card, bgr, rig, cfg, n_frames, tmp, "bgr")

        # cloud: the CLI's file, then its stages on the same frame
        out_dir = Path(tmp) / "clouds"
        _cli(["cloud", gray, "--frame", frame, "--num-disp", D, "--width",
              W, "--height", H, "--out", out_dir, "--device", DEVICE])
        pcd_xyz, _, _ = read_pcd(out_dir / f"frame_{frame:05d}.pcd")
        left, right = next(VideoSource(gray).frames(start=frame))
        gen = PointCloudGenerator(rig, CloudConfig(sgbm=params, leaf=5.0),
                                  device=DEVICE)
        lt = torch.tensor(np.float32(left), device=DEVICE)
        rt = torch.tensor(np.float32(right), device=DEVICE)
        disp, launches = _counted(lambda: gen.disparity(lt, rt))
        _expect_launches("host cloud", launches, MATCHER_PER_CALL, 1)
        ref = plain.sgbm(lt[None], rt[None], params)[0]
        if not torch.equal(disp, ref):
            raise AssertionError(
                f"cloud disparity differs from the plain matcher at "
                f"{int((disp != ref).sum())} pixels")
        pts = gen.kept_points(disp)
        cols = torch.tensor(np.repeat(np.float32(left)[..., None], 3, 2
                                      ).reshape(-1, 3), device=DEVICE)
        vp, _, n = voxel_downsample(pts, cols, 5.0)
        cp, _, cn = voxel_downsample(pts.cpu(), cols.cpu(), 5.0)
        n, cn = int(n), int(cn)
        err = max_abs_err(vp[:n].cpu(), cp[:cn])
        if n != cn or err > 1e-3 or len(pcd_xyz) != n:
            raise AssertionError(f"voxels: card {n}, CPU {cn}, file "
                                 f"{len(pcd_xyz)}, max |err| {err}")
        pcd_err = max_abs_err(torch.from_numpy(pcd_xyz), cp[:cn])
        if pcd_err > 1e-3:
            raise AssertionError(f"the CLI's cloud differs from the CPU "
                                 f"voxels by {pcd_err}")
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            c = gen.cloud_from_pair(left, right)
        cloud_ms = (time.perf_counter() - t0) * 1e3 / reps
        t0 = time.perf_counter()
        write_pcd(Path(tmp) / "w.pcd", c["points"], c["colors"])
        write_ms = (time.perf_counter() - t0) * 1e3
        split = {"matcher": cuda_ms(lambda: gen.disparity(lt, rt), 3),
                 "reproject + keep": cuda_ms(lambda: gen.kept_points(disp),
                                             5),
                 "voxel": cuda_ms(lambda: voxel_downsample(pts, cols, 5.0),
                                  5)}
        log(f"host cloud [{card}]: frame {frame}, {n} voxels of "
            f"{int(torch.isfinite(pts).all(1).sum())} kept points (card == "
            f"CPU, centroids max |err| {err:.2e}; file max |err| "
            f"{pcd_err:.2e}); disparity == plain matcher; launches "
            f"{launches}")
        log(f"host cloud [{card}]: {cloud_ms:.3f} ms per cloud_from_pair "
            f"(host clock, {reps} calls); matcher {split['matcher']:.3f}, "
            f"reproject + keep {split['reproject + keep']:.3f}, voxel "
            f"{split['voxel']:.3f} ms (CUDA events); PCD write "
            f"{write_ms:.3f} ms (Python io/pcd.py; the native library is "
            f"{'built' if native.available() else 'not built'})")

        # measure: two points on the nearest box of frame 3
        gt = np.load(Path(tmp) / "gt.npy")[frame]
        near = gt[:, D + 16:] == gt[:, D + 16:].max()
        ys, xs = np.nonzero(near)
        y = int(np.median(ys))
        row = xs[ys == y] + D + 16
        p1 = (int(row[len(row) // 4]), y)
        p2 = (int(row[3 * len(row) // 4]),
              int(ys.min() + (ys.max() - ys.min()) // 4))
        text = _cli(["measure", gray, "--frame", frame, "--num-disp", D,
                     "--width", W, "--height", H, "--points",
                     f"{p1[0]},{p1[1]},{p2[0]},{p2[1]}", "--device",
                     DEVICE])
        printed = text.strip().split(": ")[-1]
        pipe = StereoPipeline(rig, cfg, device=DEVICE)    # the CLI's too
        xyz = pipe.xyz_hwc(pipe.process_pair(left, right)["xyz"])
        mine = f"{measure_distance(xyz, p1, p2) / 10.0:.5f} cm"
        f_px, base = rig.Q[2, 3], 1.0 / rig.Q[3, 2]
        cx, cy = -rig.Q[0, 3], -rig.Q[1, 3]

        def gt_xyz(p):
            z = f_px * base / gt[p[1], p[0]]
            return np.array([(p[0] - cx) * z / f_px, (p[1] - cy) * z / f_px,
                             z])

        truth = np.linalg.norm(gt_xyz(p1) - gt_xyz(p2)) / 10.0
        log(f"host measure: {p1} -> {p2} on the nearest box: cli "
            f"{printed}, measure_distance on the pipeline's xyz {mine}, "
            f"ground truth {truth:.5f} cm")
        if printed != mine or "nan" in mine:
            raise AssertionError(f"cli measure {printed} != {mine}")
    log(f"host phase: {time.perf_counter() - t_phase:.1f} s")


def _check_spans(tag, run):
    """Each timed run's CUDA-event span against its host-clock span (from
    before its first launch to after a synchronize): the events must
    bracket the device work, so the two agree."""
    ratios = [e / h for e, h in zip(run.event_ms, run.host_ms)]
    log(f"bench {tag}: event ms {run.event_ms}, host-clock ms "
        f"{run.host_ms}, event / host {ratios}")
    if min(ratios) < 0.95:
        raise AssertionError(f"{tag}: the events' span is shorter than the "
                             f"host clock's: {ratios}")


def _check_plain_full(tag, pipe, got, lefts, rights):
    """``got``, the full pipeline's (B, ...) outputs on ``lefts``,
    ``rights``, against its plain path: rectify at the pipeline's remap
    precision, the plain matcher on each frame's left view and mirrored
    right view, the plain WLS and reproject_to_3d; every output bitwise."""
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import wls as wplain
    from stereo_depth_ruler_tpu_torch.ops.remap import remap_bilinear
    from stereo_depth_ruler_tpu_torch.ops.reproject import reproject_to_3d
    cfg, params = pipe.config, pipe.config.sgbm
    lr, rr = (remap_bilinear(torch.as_tensor(f, dtype=torch.float32,
                                             device=DEVICE), g,
                             cfg.remap_precision)
              for f, g in ((lefts, pipe.grid_l), (rights, pipe.grid_r)))
    dl, dr = torch.empty_like(lr), torch.empty_like(lr)
    for i in range(lr.shape[0]):
        dd = plain.sgbm(torch.stack([lr[i], rr[i].flip(-1)]),
                        torch.stack([rr[i], lr[i].flip(-1)]), params)
        dl[i], dr[i] = dd[0], dd[1].flip(-1)
    disp, conf = wplain.wls_disparity_filter(
        dl, dr, lr, max_disp=params.num_disparities + params.min_disparity)
    want = {"left_rectified": lr, "right_rectified": rr, "disparity": disp,
            "confidence": conf,
            "xyz": reproject_to_3d(disp, pipe.rig.Q,
                                   quirk_compat=cfg.quirk_compat,
                                   handle_missing=cfg.handle_missing,
                                   layout="chw")}
    for k, v in want.items():
        if not torch.equal(got[k], v):
            raise AssertionError(f"{tag}: {k} differs from the plain path")
    log(f"{tag}: {', '.join(want)} bitwise equal to the plain path on "
        f"{lr.shape[0]} frames (rectify {cfg.remap_precision}, valid "
        f"{float((disp >= 0).float().mean())})")


def phase_bench(card):
    """The port's bench (stereo_depth_ruler_tpu_torch/bench.py) and entry
    points on the card: the flagship (batch 8, LR, speckle 200/2, depth),
    its first batch bitwise to the plain matcher + reproject_to_3d frame by
    frame; the full pipeline, its first batch bitwise to the plain path
    (rectify, the plain matcher on each frame's left and mirrored right
    view, the plain WLS, reproject_to_3d) and to
    StereoPipeline.process_batch on the uint8 frames; the 2560x1440x256
    sweep bitwise to the plain matcher; launches per call exact for each;
    the pinned cv2 baseline (30 frames x 5 trials); entry()'s forward on
    its noise pair and on the bench's first frame, disparity and xyz
    bitwise to the plain matcher + reproject_to_3d, and
    entry_full_pipeline() launching the full path once. Prints the bench's
    JSON line."""
    import cv2
    import torch
    from stereo_depth_ruler_tpu_torch import bench, entry
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops.reproject import reproject_to_3d
    t_phase = time.perf_counter()
    rig, lefts, rights = bench.make_inputs()
    log(f"bench: cv2 {cv2.__version__}, {cv2.getNumThreads()} threads, "
        f"host CPU {bench.host_cpu()!r}")
    cv_fps = bench.bench_opencv(lefts, rights)

    flag, launches = _counted(lambda: bench.bench_flagship(
        rig, lefts, rights, device=DEVICE))
    _expect_launches("bench flagship", launches, MATCHER_PER_CALL,
                     flag.calls)
    _check_spans("flagship", flag)
    params = entry.flagship_params(bench.D)
    disp, z = flag.first
    for i in range(len(lefts)):
        ref = plain.sgbm(torch.tensor(np.float32(lefts[i:i + 1]),
                                      device=DEVICE),
                         torch.tensor(np.float32(rights[i:i + 1]),
                                      device=DEVICE), params)
        if not (torch.equal(disp[i:i + 1], ref) and torch.equal(
                z[i:i + 1], reproject_to_3d(ref, rig.Q)[..., 2])):
            raise AssertionError(f"bench flagship frame {i} differs from "
                                 f"the plain matcher + reproject_to_3d")
        if i == 0:
            ref0 = ref[0]
    log(f"bench flagship: {len(lefts)} frames bitwise equal to the plain "
        f"matcher + reproject_to_3d; {flag.fps} frames/s")
    flag.first = None
    del disp, z, ref

    full, launches = _counted(lambda: bench.bench_full_pipeline(
        rig, lefts, rights, device=DEVICE))
    _expect_launches("bench full pipeline", launches, FULL_PATH_PER_BATCH,
                     full.calls)
    _check_spans("full pipeline", full)
    pipe = entry.full_pipeline(rig, params, DEVICE)
    want = pipe.process_batch(lefts, rights)
    for k in ("disparity", "xyz"):
        if not torch.equal(full.first[k], want[k]):
            raise AssertionError(f"bench full pipeline: {k} differs from "
                                 f"process_batch on the uint8 frames")
    want = None
    _check_plain_full("bench full pipeline", pipe, full.first, lefts, rights)
    log(f"bench full pipeline: bitwise equal to process_batch on the "
        f"uint8 frames; {full.fps} frames/s")
    full.first = None
    torch.cuda.empty_cache()

    sweep, launches = _counted(lambda: bench.bench_sweep(device=DEVICE))
    _expect_launches("bench sweep", launches, MATCHER_PER_CALL,
                     sweep.calls)
    _check_spans("sweep", sweep)
    got, sweep.first = sweep.first, None
    torch.cuda.empty_cache()
    left, right = bench.sweep_inputs(*bench.SWEEP[:2])
    ref = plain.sgbm(torch.tensor(left[None], device=DEVICE),
                     torch.tensor(right[None], device=DEVICE),
                     entry.flagship_params(bench.SWEEP[2]))
    if not torch.equal(got, ref):
        raise AssertionError(f"bench sweep differs from the plain matcher "
                             f"at {int((got != ref).sum())} pixels")
    log(f"bench sweep: bitwise equal to the plain matcher (valid "
        f"{float((got >= 0).float().mean())}); {sweep.fps} frames/s")
    del got, ref
    torch.cuda.empty_cache()

    # entry()'s forward on its own noise pair (few valid pixels) and on
    # the bench's first frame (a scene), against the plain matcher and
    # reproject_to_3d; the synthetic rig is the bench's
    fn, (left, right) = entry.entry(DEVICE)
    outs, launches = _counted(lambda: [fn(left, right),
                                       fn(lefts[0], rights[0])])
    _expect_launches("bench entry()", launches, MATCHER_PER_CALL, 2)
    refs = [plain.sgbm(left[None], right[None], params)[0], ref0]
    for tag, (disp, xyz), ref in zip(("its pair", "the bench's frame 0"),
                                     outs, refs):
        if not (torch.equal(disp, ref)
                and torch.equal(xyz, reproject_to_3d(ref, rig.Q))):
            raise AssertionError(f"entry()'s forward on {tag} differs from "
                                 f"the plain matcher + reproject_to_3d")
        log(f"bench entry() on {tag}: disparity {tuple(disp.shape)} and "
            f"xyz {tuple(xyz.shape)} bitwise equal to the plain matcher + "
            f"reproject_to_3d, valid {float((disp >= 0).float().mean())}")
    del outs, refs, ref0
    fn, (left, right) = entry.entry_full_pipeline(DEVICE)
    out, launches = _counted(lambda: fn(left, right))
    _expect_launches("bench entry_full_pipeline()", launches,
                     FULL_PATH_PER_BATCH, 1)
    _check_plain_full("bench entry_full_pipeline()", pipe,
                      {k: v[None] for k, v in out.items()}, left[None],
                      right[None])
    del disp, xyz, ref, out, pipe
    torch.cuda.empty_cache()

    line = bench.result_line(cv_fps, flag, full, sweep,
                             bench.card_name(torch.device(DEVICE)))
    log(f"bench phase: {time.perf_counter() - t_phase:.1f} s")
    log(card)
    log(json.dumps(line))


def profile_path(card, pipe, frames, reps=3):
    """Device time by kernel over ``reps`` batches of the path, and the
    share of the wall time the device was busy (one stream, so the sum of
    kernel times)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, lefts, rights, _ = frames
    pipe.process_batch(lefts, rights)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pipe.process_batch(lefts, rights)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kern)
    log(f"profile {pipe.config.pair_mode} [{card}]: "
        f"{wall_ms / reps:.2f} ms per batch wall (under "
        f"the profiler), device busy {busy:.2f} ms "
        f"({100 * busy * reps / wall_ms:.1f} %)")
    for name, ms, n in kern[:16]:
        log(f"profile: {ms:9.3f} ms per batch  x{n:<3d} {name[:90]}")


def main():
    if not (ROOT / "stereo_depth_ruler_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repo "
                         "(stereo_depth_ruler_tpu_torch/ not found)")
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    errs = {}
    phase_kernels(errs)
    phase_matcher()
    frames = render_frames(*MAIN[:3])
    times1, bounds1, rect, passes = phase_main_path(card, errs, frames)
    launches5, times5, bounds5 = phase_staged_chain(card, errs, rect)
    del rect
    launches, times2, bounds2, stacked, maps = phase_full_path(card, errs,
                                                               frames)
    launches4, times4, bounds4 = phase_sort_family(card, errs, maps, 2, 200)
    del maps
    import torch
    torch.cuda.empty_cache()
    profile_path(card, stacked[0], frames)
    launches3, times3, bounds3, pipe = phase_shared_path(card, errs, frames,
                                                         stacked)
    full_pipe = stacked[0]
    del stacked
    profile_path(card, pipe, frames)
    del pipe
    torch.cuda.empty_cache()
    phase_configs(card, errs, frames)
    launches6, times6, bounds6 = phase_sharded(card, errs, frames, full_pipe)
    del full_pipe
    torch.cuda.empty_cache()
    phase_host(card)
    torch.cuda.empty_cache()
    phase_bench(card)
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    launches.update({k: passes[k] for k in PASSES})
    launches.update({k: launches3[k] for k in (*PAIR_MODES,
                                               "wta_lr_mirror")})
    launches.update({k: launches4[k] for k in SORT_FAMILY})
    launches.update({k: launches5[k] for k in (*STAGED_CHAIN, *TRANSPOSES)})
    launches["sgbm_tile"] = launches6["sgbm_tile"]
    times = {**times1, **times2, **times3, **times4, **times5, **times6}
    bounds = {**bounds1, **bounds2, **bounds3, **bounds4, **bounds5,
              **bounds6}

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": times[name][2]}
               for name, (src, rep) in KERNELS.items()]
    log(f"smoke: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
