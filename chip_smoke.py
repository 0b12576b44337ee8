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
   counts, frames/s and peak memory; then K1-K3 on the main path's own
   inputs (8x720x1280x128) against their plain versions, bitwise, and
   timed; then the staged chain on the same rectified frames: a counted
   run of sgbm_staged_cuda, which must launch the fused cost + down kernel
   once, K2 on an int16 S five times and the three-input WTA/LR once, and
   none of K1-K3; its map equal to sgbm_cuda's and to the slice-1 path's;
   cost_down's C equal to K1's and its sum to three K2 passes; the three
   kernels against their plain versions on the full batch, timed, the two
   chains timed in turns, and their peak memory; then a counted run of
   the stage profiler (tools/profile_stages_torch.py), which launches the
   three volume transposes, and the transposes on one frame's volume
   ((128, 720, 1280), int16, int32 and bfloat16) against
   permute().contiguous(), bitwise, there and back, and timed;
6. full main path: the same frames through the reference's configuration
   (speckle 200/2, right matcher on the stacked 16 frames, WLS filter), at
   the WLS accuracy bar (valid > 0.95, MAE < 0.7 px outside the left 128
   columns), with launch counts proving K1-K7 ran, frames/s and peak
   memory; then K1-K7 on that path's own inputs (K1-K3 on the 16 stacked
   frames, 16x720x1280x128) against their plain versions, bitwise, and
   K4-K7 timed; then torch.profiler traces three batches of the
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
   torch.sort(stable=True) on 16 x 2^20 keys, the run modes, the
   compositions, the seeded keep against K5's; then times (kernel,
   plain, torch.sort for the sorts) and bounds;
8. shared path: the full path's configuration with pair_mode="shared"
   (K1's pair mode builds both matchers' volumes from one cost build, K3's
   mirror mode runs the right matcher's WTA/LR), at the WLS bar, with
   launch counts proving both modes ran; every output equal to the stacked
   path's; ms per batch at batch 8 and ms per process_pair at batch 1 for
   both pair modes, timed in turns; then K1's pair mode, K2 and K3's mirror
   mode on the path's own inputs (8x720x1280x128, both volumes) against
   their plain versions frame by frame, bitwise, the two modes timed, and
   sgbm_pair_cuda's two maps equal to the stacked matcher's; then a
   profile of the shared path.

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
}
# the pair modes, launched only by the shared path
PAIR_MODES = ("cost_box_pair", "wta_lr_mirror")
# the kernels the full path launches, and no other
FULL_PATH = {"cost_box", "sgm_pass", "wta_lr", "speckle_labels",
             "speckle_keep", "fgs_pass", "shift_gather"}
# the sort family's kernels, launched by its entry points only
SORT_FAMILY = ("sweep_labels", "sweep_propagate", "radix_sort_keys",
               "radix_sort_pairs", "sorted_runs_sizes", "sorted_runs_keep",
               "sorted_runs_roots")
# the staged chain's kernels and their launches per sgbm_staged_cuda call
# with 8 paths, and the transposes, launched by the stage profiler
STAGED_CHAIN = {"cost_down": 1, "sgm_pass_i16": 5, "wta_lr3": 1}
TRANSPOSES = ("transpose_vol", "transpose_leading", "transpose_dhw")
DEVICE = "cuda"
# (H, W, D) of the K1-K3 checks; the serpentine's (H, W); the main path's
# batch, H, W and D (the JAX package's headline widths)
KERNEL_SHAPES = ((32, 48, 16), (96, 160, 48), (720, 1280, 128))
SERPENTINE = (720, 1280)
MAIN = (8, 720, 1280, 128)


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
    # K1 at block 5 (the main paths'): the single-volume and the pair kernel
    k1 = re.findall(r"entry function '\w*(cost_box|cost_pair)_kernelILi5E\w*'"
                    r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers",
                    ptxas)
    log("ptxas: K1 at block 5: " + ", ".join(f"{name}_kernel {n} registers"
                                              for name, n in k1))
    # the matcher kernels at 128 disparities (4 per lane): K2 and K3 as the
    # three paths run them, and the staged chain's beside them
    d128 = re.findall(
        r"entry function '\w*?\d+(sgm_pass_kernel|sgm_pass_i16_kernel|"
        r"wta_lr_kernel|wta_lr3_kernel|cost_down_kernel)ILi4E(?:Lb([01])E)?"
        r"\w*'[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers", ptxas)
    log("ptxas: at 4 disparities per lane: " + ", ".join(
        f"{name}{'<acc>' if acc == '1' else ''} {n} registers"
        for name, acc, n in d128))


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
    disp = out["disparity"].cpu().numpy()
    if not np.isfinite(disp).all() or not np.isfinite(
            out["frame_stats"][:, :2].cpu().numpy()).all():
        raise AssertionError("non-finite disparity or stats")
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
    if min(launches[k] for k in ("cost_box", "sgm_pass", "wta_lr")) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
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
    # per volume element: K1 ~14 (BT terms, min, sliding box sum), K2 ~8
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
    del C, S, C_p, S_p
    torch.cuda.empty_cache()
    return times, bounds, (out["left_rectified"], out["right_rectified"],
                           out["disparity"], params)


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
    del C, lt, rt
    dm = sc.wta_lr(S, params)
    del S
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
    xs = torch.arange(W, dtype=torch.float32, device=dl.device)
    idx = torch.round(xs - dl).clamp(0, W - 1).to(torch.int64)
    n = 2 * len(wplain.fgs_lambdas(8000.0, 3))
    times = {
        "speckle_labels": (cuda_ms(lambda: sc.speckle_labels(dm, r), 5),
                           cuda_ms(lambda: plain.speckle_labels(dm, r), 1),
                           None),
        "speckle_keep": (cuda_ms(lambda: sc.speckle_keep(dm, labels, ws), 5),
                         cuda_ms(lambda: plain.speckle_keep(dm, labels, ws),
                                 1), None),
        "shift_gather": (cuda_ms(lambda: wc.shift_gather_conf(dl, dr, D), 5),
                         cuda_ms(lambda: wplain.shift_gather_conf(dl, dr, D),
                                 2),
                         cuda_ms(lambda: torch.gather(dr, -1, idx), 5)),
        "fgs_pass": (cuda_ms(lambda: wc.fgs_filter_cuda(rhs, lrect), 3) / n,
                     cuda_ms(lambda: wplain.fgs_filter(rhs, lrect), 1) / n,
                     None),
    }
    px2, px = 2 * B * H * W, B * H * W
    # K6 per pixel and launch (mean of the row and the column pass): two
    # PCR solves of ceil(log2 N) rounds at ~16 operations (2 divisions,
    # 14 multiplies and adds) on two right-hand sides' worth of state,
    # plus ~30 for the weights, coefficients and residual
    rounds = ((W - 1).bit_length() + (H - 1).bit_length()) / 2
    bounds = {
        "speckle_labels": bound(8 * px2, 4 * px2),
        "speckle_keep": bound(12 * px2, 3 * px2),
        "shift_gather": bound(16 * px, 10 * px),
        "fgs_pass": bound(20 * px, (2 * 16 * rounds + 30) * px),
    }
    for name, (ms, plain_ms, lib_ms) in times.items():
        lib = f", torch.gather {lib_ms:.3f} ms" if lib_ms else ""
        log(f"full path [{card}]: {name}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms{lib}, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}) per launch")
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
    hold("sorted_runs_sizes", soc.run_sizes(skey), splain.run_sizes(skey))
    hold("sorted_runs_sizes", soc.run_sizes(skey, sidx, n),
         splain.run_sizes(skey, sidx, n))
    hold("sorted_runs_sizes", counts, splain.equal_value_counts(labels))
    hold("sorted_runs_keep", soc.run_keep(skey, sidx, n, ws),
         splain.run_keep(skey, sidx, n, ws))
    hold("sorted_runs_keep", soc.speckle_keep_sorted(labels, ws),
         splain.speckle_keep_sorted(labels, ws))
    hold("sorted_runs_keep", kept, plain.speckle_filter(dm, dm >= 0, ws, r, 3))
    hold("sorted_runs_roots", soc.large_run_roots(skey, n2, L, ws),
         splain.large_run_roots(skey, n2, L, ws))
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
    # bytes: each input read once, each output written once. Operations:
    # the sweep ~6 per pixel, sweep and round; the sort ~4 per key and
    # pass; the run scans a binary search of log2(n2) steps each way, ~3
    # operations a step
    steps = n2.bit_length()
    bounds = {
        "sweep_labels": bound(8 * px, 6 * 4 * rounds_lab * px),
        "sweep_propagate": bound(12 * px, 6 * 4 * rounds_prop * px),
        "radix_sort_keys": bound(8 * keys, 16 * keys),
        "radix_sort_pairs": bound(16 * keys, 16 * keys),
        "sorted_runs_sizes": bound(8 * keys + 4 * B * n, 6 * steps * keys),
        "sorted_runs_keep": bound(8 * keys + B * n, 6 * steps * keys),
        "sorted_runs_roots": bound(4 * keys + 4 * B * R * slots, 4 * keys),
    }
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
            != FULL_PATH - {"cost_box", "wta_lr"} | set(PAIR_MODES)):
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
    del S, S_f, disp
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
              "wta_lr_mirror": bound(2 * (4 * el + 4 * px), 2 * 4 * el)}
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
    return launches, times, bounds, pipe


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
    times1, bounds1, rect = phase_main_path(card, errs, frames)
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
    del stacked
    profile_path(card, pipe, frames)
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    launches.update({k: launches3[k] for k in PAIR_MODES})
    launches.update({k: launches4[k] for k in SORT_FAMILY})
    launches.update({k: launches5[k] for k in (*STAGED_CHAIN, *TRANSPOSES)})
    times = {**times1, **times2, **times3, **times4, **times5}
    bounds = {**bounds1, **bounds2, **bounds3, **bounds4, **bounds5}

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
