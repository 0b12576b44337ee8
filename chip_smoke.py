#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: builds the CUDA kernels from ops/csrc with nvcc;
3. kernels: K1 cost, K2's 8 passes and K3 (LR on and off) against their
   plain PyTorch versions, bitwise, at 32x48x16, 96x160x48 and
   720x1280x128;
4. matcher: sgbm_cuda against the NumPy oracle sgbm_ref.sgbm_numpy,
   bitwise, on a 32x48 synthetic pair with 16 disparities;
5. main path: StereoPipeline.process_batch on 8 synthetic 1280x720 frames
   (u8 rectify, 128 disparities, 8 paths, in-matcher LR, speckle off),
   checked against the rendered ground truth, with launch counts, frames/s
   and peak memory; then each kernel on the main path's own inputs
   (8x720x1280x128) against its plain version, bitwise, and both timed.

The last two lines are a JSON object with one record per kernel and the
JSON object {"ok": true, "device": {...}}. The port imports no JAX: the
reference package's NumPy oracle, calibration and synthetic-scene modules
are framework-free, and the run checks that JAX stays unloaded.
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
    "sgm_pass": ("stereo_depth_ruler_tpu_torch/ops/csrc/sgm_pass.cu",
                 "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:606"),
    "wta_lr": ("stereo_depth_ruler_tpu_torch/ops/csrc/wta_lr.cu",
               "stereo_depth_ruler_tpu/ops/sgbm_pallas.py:1463"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches (after one
    warm-up call), timed with CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    """Largest |a - b| (inf if the shapes differ)."""
    a = a.double()
    b = b.double()
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).abs().max()) if a.numel() else 0.0


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
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    ptxas = lib.with_suffix(".log").read_text()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", ptxas)]
    log(f"ptxas: {len(regs)} kernel instances, registers "
        f"{min(regs)}..{max(regs)}, spill stores {max(spills)} bytes max")


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


def phase_kernels(errs):
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops.sgbm import sobel_clip
    for H, W, D in ((32, 48, 16), (96, 160, 48), (720, 1280, 128)):
        params = SGBMParams(num_disparities=D, block_size=5,
                            speckle_window_size=0)
        left, right = _pair(H, W, D // 3, seed=H)
        lt = sobel_clip(torch.tensor(left, device="cuda"), 63)
        rt = sobel_clip(torch.tensor(right, device="cuda"), 63)
        check_kernels(lt, rt, params, errs)
        torch.cuda.empty_cache()


def phase_matcher():
    import torch
    from stereo_depth_ruler_tpu.io.synthetic import (make_scene,
                                                     render_stereo_pair)
    from stereo_depth_ruler_tpu.ops.sgbm_ref import sgbm_numpy
    from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
    from stereo_depth_ruler_tpu_torch.ops.sgbm_cuda import sgbm_cuda
    rig = StereoRig.synthetic(width=48, height=32, focal=50.0,
                              baseline_mm=30.0)
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 400.0),
                       background_z_mm=700.0, seed=1)
    left, right, _ = render_stereo_pair(scene, seed=1)
    for num_paths in (2, 4, 8):
        params = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                            speckle_window_size=0, num_paths=num_paths)
        ref = sgbm_numpy(left, right, params, apply_speckle=False)
        got = sgbm_cuda(torch.tensor(np.float32(left[None]), device="cuda"),
                        torch.tensor(np.float32(right[None]), device="cuda"),
                        params)[0].cpu().numpy()
        torch.cuda.synchronize()
        n_bad = int((got != ref).sum())
        log(f"matcher vs sgbm_numpy, 32x48x16, {num_paths} paths: "
            f"{n_bad} differing pixels, valid {(got >= 0).mean():.3f}")
        if n_bad:
            raise AssertionError("sgbm_cuda differs from sgbm_numpy")


def phase_main_path(card, errs):
    import torch
    from stereo_depth_ruler_tpu.io.synthetic import (make_scene,
                                                     render_stereo_pair)
    from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                       StereoPipeline)
    H, W, D, B = 720, 1280, 128, 8
    t0 = time.perf_counter()
    rig = StereoRig.synthetic(width=W, height=H)
    scene = make_scene(rig, n_boxes=5, z_range_mm=(900.0, 4000.0),
                       background_z_mm=6000.0, seed=0)
    frames = [render_stereo_pair(scene, seed=0, shift=(2.0 * i, 0.0))
              for i in range(B)]
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    gts = np.stack([f[2] for f in frames])
    log(f"main path: {B} frames {W}x{H} rendered in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = PipelineConfig(
        sgbm=SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=0),
        downscale=1, use_wls=False, lr_mode="fast", remap_precision="u8")
    pipe = StereoPipeline(rig, cfg, rectify=True, device="cuda")
    pipe.process_batch(lefts, rights)          # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    sc.reset_launch_counts()
    out = pipe.process_batch(lefts, rights)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")

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
    band = slice(D, None)       # the left D-column band has no partner
    d, g = disp[..., band], gts[..., band]
    ok = d >= 0
    vfrac = float(ok.mean())
    mae = float(np.abs(d[ok] - g[ok]).mean())
    log(f"main path accuracy (outside the left {D} columns): valid "
        f"{vfrac:.4f} (bar >= 0.9), MAE {mae:.4f} px (bar <= 0.5)")
    if not (vfrac >= 0.9 and mae <= 0.5):
        raise AssertionError(f"accuracy bar missed: valid {vfrac}, "
                             f"MAE {mae}")

    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pipe.process_batch(lefts, rights)
    end.record()
    torch.cuda.synchronize()
    batch_ms = start.elapsed_time(end) / reps
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
                     cuda_ms(lambda: plain.cost_volume(lt, rt, params), 1)),
        "sgm_pass": (cuda_ms(lambda: sc.aggregate(C, params), 2) / n_dirs,
                     cuda_ms(lambda: plain.aggregate_paths(
                         C_p, params.P1, params.P2, 8), 1) / n_dirs),
        "wta_lr": (cuda_ms(lambda: sc.wta_lr(S, params), 3),
                   cuda_ms(lambda: plain.wta_lr(S_p, params), 1)),
    }
    for name, (ms, plain_ms) in times.items():
        log(f"main path [{card}]: {name} at {B}x{H}x{W}x{D}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms per launch")
    return launches, times


def main():
    if not (ROOT / "stereo_depth_ruler_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repo "
                         "(stereo_depth_ruler_tpu_torch/ not found)")
    card = phase_device()
    phase_build()
    errs = {}
    phase_kernels(errs)
    phase_matcher()
    launches, times = phase_main_path(card, errs)
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")

    import torch
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src, rep) in KERNELS.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
