"""Stage-by-stage timing of the PyTorch + CUDA matcher (dev tool).

Counterpart of tools/profile_stages.py for the port. It times, through
``utils.profiling.roofline_report`` (CUDA events on the card), the stages
of both matcher chains on one random pair:

- the fused chain, ``sgbm_cuda(fused_wta=False)``: Sobel, K1 cost, K2's
  directional passes into an int32 S, K3 WTA/LR, K4 + K5 speckle (at its
  defaults ``sgbm_cuda`` takes the batch sweeps instead, which
  chip_smoke.py times in turns with this chain);
- the staged chain of ``sgbm_staged_cuda``: Sobel, the fused cost + down
  kernel, the horizontal and up-going passes into int16 partial sums, the
  three-input WTA/LR, K4 + K5;
- the three volume transposes at the shapes the JAX tool times them,
  (D, H, W) -> (W, D, H), (W, D, H) -> (H, D, W) and (D, H, W) ->
  (H, D, W) on an int16 volume, each beside ``permute().contiguous()``;
- both matchers whole.

The table and the two chains' sums go to stderr.

    python tools/profile_stages_torch.py                  # 720x1280x128, card
    python tools/profile_stages_torch.py --device cpu --size 24x40x16

With ``--device cpu`` the plain versions run (small sizes only); the times
are then the CPU's and only show that every stage runs.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.utils.profiling import (StageSpec,
                                                          roofline_report)

FUSED = "fused"
STAGED = "staged"


def build_stages(device="cuda", H=720, W=1280, D=128, batch=1, seed=0):
    """The stages as (chain tags, StageSpec) pairs; the tags say which of
    the two chains' sums a stage counts towards."""
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    rng = np.random.default_rng(seed)
    left = torch.tensor(rng.uniform(0, 255, (batch, H, W)).astype(np.float32),
                        device=device)
    right = torch.tensor(np.roll(left.cpu().numpy(), -(D // 3), axis=2),
                         device=device)
    cap, P1, P2 = params.pre_filter_cap, params.P1, params.P2
    lt = plain.sobel_clip(left, cap).contiguous()
    rt = plain.sobel_clip(right, cap).contiguous()
    C = sc.cost_volume(lt, rt, params)
    S = sc.aggregate(C, params)
    S_down = sc.cost_down(lt, rt, params)[1]
    S_h = sc.aggregate_i16(C, params, [(0, 1), (0, -1)])
    up = plain.up_dirs(params.num_paths)
    S_up = sc.aggregate_i16(C, params, up)
    disp = sc.wta_lr(S, params)
    labels = sc.speckle_labels(disp, params.speckle_range)
    Cd = C[0].permute(2, 0, 1).contiguous()        # (D, H, W)
    Cw = plain.transpose_dhw_to_wdh(Cd)            # (W, D, H)
    S16 = torch.empty_like(C)
    px, el, vol = batch * H * W, batch * H * W * D, 2 * H * W * D
    bound3 = sc.path_sum_bound(params, 3)

    def spec(tags, name, fn, nbytes, flops=0.0):
        return tags, StageSpec(name, fn, nbytes, flops)

    stages = [spec((FUSED, STAGED), "sobel x2", lambda: (
        plain.sobel_clip(left, cap), plain.sobel_clip(right, cap)),
        16 * px, 20 * px)]
    stages.append(spec((FUSED,), "K1 cost_volume",
                       lambda: sc.cost_volume(lt, rt, params),
                       8 * px + 2 * el, 14 * el))
    for i, (dy, dx) in enumerate(params.path_dirs):
        stages.append(spec(
            (FUSED,), f"K2 pass ({dy:+d},{dx:+d}) int32 S"
            + (" +acc" if i else ""),
            lambda dy=dy, dx=dx, i=i: sc.sgm_pass(C, S, dy, dx, P1, P2,
                                                  i > 0),
            (10 if i else 6) * el, 8 * el))
    stages.append(spec((FUSED,), "K3 wta_lr", lambda: sc.wta_lr(S, params),
                       4 * el + 4 * px, 4 * el))
    stages.append(spec((STAGED,), "cost_down (C + down sum)",
                       lambda: sc.cost_down(lt, rt, params),
                       8 * px + 4 * el, (14 + 8 * len(up)) * el))
    for dirs in ([(0, 1), (0, -1)], up):
        for i, (dy, dx) in enumerate(dirs):
            stages.append(spec(
                (STAGED,), f"K2 pass ({dy:+d},{dx:+d}) int16 S"
                + (" +acc" if i else ""),
                lambda dy=dy, dx=dx, i=i: sc.sgm_pass(
                    C, S16, dy, dx, P1, P2, i > 0, sum_bound=bound3),
                (6 if i else 4) * el, 8 * el))
    stages.append(spec((STAGED,), "wta_lr3",
                       lambda: sc.wta_lr3(S_down, S_up, S_h, params),
                       6 * el + 4 * px, 6 * el))
    stages.append(spec((FUSED, STAGED), "K4 speckle_labels",
                       lambda: sc.speckle_labels(disp, params.speckle_range),
                       8 * px, 4 * px))
    stages.append(spec((FUSED, STAGED), "K5 speckle_keep",
                       lambda: sc.speckle_keep(disp, labels,
                                               params.speckle_window_size),
                       12 * px, 3 * px))
    for name, fn, lib, x in (
            ("(D,H,W)->(W,D,H)", sc.transpose_dhw_to_wdh,
             plain.transpose_dhw_to_wdh, Cd),
            ("(W,D,H)->(H,D,W)", sc.transpose_vol, plain.transpose_vol, Cw),
            ("(D,H,W)->(H,D,W)", sc.transpose_leading,
             plain.transpose_leading, Cd)):
        stages.append(spec((), f"transpose {name} [kernel]",
                           lambda fn=fn, x=x: fn(x), 2 * vol))
        stages.append(spec((), f"transpose {name} [permute.contiguous]",
                           lambda lib=lib, x=x: lib(x), 2 * vol))
    stages.append(spec((), "sgbm_cuda whole (fused_wta=False)",
                       lambda: sc.sgbm_cuda(left, right, params,
                                            fused_wta=False),
                       36 * px + 82 * el))
    stages.append(spec((), "sgbm_staged_cuda whole",
                       lambda: sc.sgbm_staged_cuda(left, right, params),
                       36 * px + 36 * el))
    return stages


def run(device="cuda", H=720, W=1280, D=128, batch=1, reps=5, out=sys.stderr):
    """Time every stage; print the table and the two sums; return the
    report, with the chains' sums under ``chain_ms``."""
    tagged = build_stages(device, H, W, D, batch)
    report = roofline_report([s for _, s in tagged], reps=reps, device=device)
    print(f"{'stage':46s} {'ms':>9s} {'bound ms':>9s} {'of bound':>8s} "
          f"{'GB/s':>8s}", file=out)
    for r in report["stages"]:
        print(f"{r['stage']:46s} {r['ms']:9.3f} {r['bound_ms']:9.4f} "
              f"{r['sol_frac']:8.3f} {r['gbps_achieved']:8.1f}", file=out)
    report["chain_ms"] = {
        chain: sum(r["ms"] for (tags, _), r in zip(tagged, report["stages"])
                   if chain in tags) for chain in (FUSED, STAGED)}
    for chain, ms in report["chain_ms"].items():
        print(f"{'sum of stages, ' + chain + ' chain':46s} {ms:9.3f}",
              file=out, flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", default="720x1280x128", help="HxWxD")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    H, W, D = (int(v) for v in args.size.split("x"))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_stages_torch: no CUDA card; pass "
                             "--device cpu for a small run of the plain "
                             "versions")
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), file=sys.stderr)
    run(args.device, H, W, D, args.batch, args.reps)


if __name__ == "__main__":
    main()
