"""Accuracy gate of the PyTorch + CUDA port against OpenCV: the port's
matcher (``sgbm_cuda``, reference parameters with speckle 200/2) against
``cv2.StereoSGBM`` in MODE_HH on synthetic stereo frames with known ground
truth, at the bound disp_mae_px < 0.5 (the counterpart of
tools/mae_r5.py, whose JAX run is MAE_r05.json).

    python tools/mae_torch.py [--device cuda|cpu] [--size HxWxD]
                              [--frames N] [--out FILE]

Frames i = 0 .. N-1 are the scene of seed i (5 boxes, 0.9-4 m, 6 m
background) on the synthetic rig, its focal scaled by W / 1280 so that a
small CPU run keeps the disparities inside D. The left D columns have no
partner and are masked. Prints one JSON object (and writes it to --out):
the disparity MAE against cv2 over the pixels both mark valid, the depth
MAE through the rig's Q (where both depths are finite), each side's error
against the ground truth, the valid-pixel agreement, and ``pass``.
Exits 2 where cv2 is missing, 1 where the bound is missed. Needs no JAX.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BOUND_PX = 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="720x1280x128", help="HxWxD")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    try:
        import cv2
    except ImportError:
        print("mae_torch: OpenCV (cv2) is not installed; the gate compares "
              "against cv2.StereoSGBM and cannot run here", file=sys.stderr)
        return 2
    import torch

    from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
    from stereo_depth_ruler_tpu_torch.io.synthetic import (make_scene,
                                                           render_stereo_pair)
    from stereo_depth_ruler_tpu_torch.ops.sgbm_cuda import sgbm_cuda
    from stereo_depth_ruler_tpu_torch.pipeline import _resolve_device

    H, W, D = (int(v) for v in args.size.split("x"))
    dev = _resolve_device(args.device)
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    rig = StereoRig.synthetic(width=W, height=H, focal=669.900 * W / 1280)
    matcher = cv2.StereoSGBM_create(
        minDisparity=0, numDisparities=D, blockSize=5,
        P1=8 * 3 * 25, P2=32 * 3 * 25, disp12MaxDiff=1, preFilterCap=63,
        uniquenessRatio=12, speckleWindowSize=200, speckleRange=2,
        mode=cv2.STEREO_SGBM_MODE_HH)
    Q = np.asarray(rig.Q)

    rows = []
    agg = {"n_px": 0, "n_z": 0, "abs_d": 0.0, "abs_z": 0.0, "gt_cv": 0.0,
           "gt_port": 0.0, "agree": 0.0}
    for i in range(args.frames):
        scene = make_scene(rig, n_boxes=5, z_range_mm=(900.0, 4000.0),
                           background_z_mm=6000.0, seed=i)
        left, right, gt = render_stereo_pair(scene, seed=i)
        ref = matcher.compute(left, right).astype(np.float32) / 16.0
        ours = sgbm_cuda(torch.tensor(np.float32(left[None]), device=dev),
                         torch.tensor(np.float32(right[None]), device=dev),
                         params)[0].cpu().numpy()
        cv_valid = ref > 0
        port_valid = ours >= 0
        both = cv_valid & port_valid
        both[:, :D] = False        # no partner in the left D columns
        union = cv_valid | port_valid
        union[:, :D] = False
        n = int(both.sum())
        with np.errstate(divide="ignore"):
            z_cv = Q[2, 3] / (Q[3, 2] * ref + Q[3, 3])
            z_port = Q[2, 3] / (Q[3, 2] * ours + Q[3, 3])
        # a disparity of 0 is valid and at infinite depth
        zok = both & np.isfinite(z_cv) & np.isfinite(z_port)
        nz = int(zok.sum())
        sums = {"abs_d": float(np.abs(ref[both] - ours[both]).sum()),
                "abs_z": float(np.abs(z_cv[zok] - z_port[zok]).sum()),
                "gt_cv": float(np.abs(ref[both] - gt[both]).sum()),
                "gt_port": float(np.abs(ours[both] - gt[both]).sum())}
        agree = float(n / max(int(union.sum()), 1))
        rows.append({"frame": i, "disp_mae_px": sums["abs_d"] / max(n, 1),
                     "z_mae_mm": sums["abs_z"] / max(nz, 1),
                     "cv_vs_gt_px": sums["gt_cv"] / max(n, 1),
                     "port_vs_gt_px": sums["gt_port"] / max(n, 1),
                     "valid_agreement": agree, "n_both": n})
        for k, v in sums.items():
            agg[k] += v
        agg["n_px"] += n
        agg["n_z"] += nz
        agg["agree"] += agree
        print(f"frame {i}: disp MAE {rows[-1]['disp_mae_px']:.4f} px, "
              f"agree {agree:.4f}", file=sys.stderr)

    n_px = max(agg["n_px"], 1)
    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    out = {"config": f"{W}x{H}x{D}, speckle 200/2, sgbm_cuda on {dev_name} "
                     "vs cv2.StereoSGBM MODE_HH",
           "n_frames": args.frames,
           "disp_mae_px": agg["abs_d"] / n_px,
           "depth_mae_mm": agg["abs_z"] / max(agg["n_z"], 1),
           "cv_vs_gt_px": agg["gt_cv"] / n_px,
           "port_vs_gt_px": agg["gt_port"] / n_px,
           "valid_agreement": agg["agree"] / max(args.frames, 1),
           "bound": f"disp_mae_px < {BOUND_PX}",
           "frames": rows}
    out["pass"] = agg["n_px"] > 0 and out["disp_mae_px"] < BOUND_PX
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps({k: out[k] for k in ("config", "disp_mae_px",
                                          "depth_mae_mm", "valid_agreement",
                                          "pass")}))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
