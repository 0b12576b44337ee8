"""K4's union-find labels at its two candidate tile shapes, in turns (dev
tool).

``labels_tiles`` (ops/csrc/speckle.cu) owns a tile of TH x 128 pixels per
block, a warp per row: 32 rows (32 KB of shared memory, 6 blocks an SM) or
16 (16 KB, 8 blocks; twice the border rows, 1/16 of the pixels against
1/32). This script builds speckle.cu twice into a temporary directory,
once as it stands and once with the other height, and times
``sdr_speckle_labels`` of both on the
full path's 16 matcher maps before the speckle filter (the stacked
matcher on the rendered 1280x720 frames of chip_smoke.py, speckle range
2) in the turns kept, other, other, kept after one untimed turn (CUDA
events, a warm-up call before each turn), and checks that the two label
maps are equal bit for bit. One line per turn and a summary go to stdout,
with the card's name and power limit.

    python tools/speckle_tile_ab.py

It needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

import chip_smoke
from stereo_depth_ruler_tpu_torch import SGBMParams
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.pipeline import (PipelineConfig,
                                                   StereoPipeline)
from stereo_depth_ruler_tpu_torch.utils import kernels
from stereo_depth_ruler_tpu_torch.utils.profiling import stage_time

SRC = kernels.CSRC_DIR / "speckle.cu"
SHAPE = re.compile(r"constexpr int TH = (\d+);(.*\n)constexpr int TW = (\d+);")
SHAPES = ((32, 128), (16, 128))


def build(src_text, work, tag):
    """A library holding only speckle.cu's entries, from ``src_text``."""
    src = work / f"speckle_{tag}.cu"
    src.write_text(src_text)
    lib = work / f"libspeckle_{tag}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sdr_speckle_labels
    fn.argtypes = kernels._SIGNATURES["sdr_speckle_labels"]
    fn.restype = ctypes.c_int
    return fn


def variants(text):
    """{name: source} for the kept tile shape and the other one."""
    m = SHAPE.search(text)
    kept = (int(m.group(1)), int(m.group(3)))
    other = SHAPES[1] if kept == SHAPES[0] else SHAPES[0]
    return {f"{kept[0]}x{kept[1]} (kept)": text,
            f"{other[0]}x{other[1]}": SHAPE.sub(
                f"constexpr int TH = {other[0]};\\g<2>"
                f"constexpr int TW = {other[1]};", text)}


def matcher_maps(B, H, W, D):
    """The full path's 2B matcher maps before the speckle filter."""
    rig, lefts, rights, _ = chip_smoke.render_frames(B, H, W)
    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    cfg = PipelineConfig(sgbm=params, downscale=1, use_wls=True,
                         lr_mode="right_matcher", remap_precision="u8")
    out = StereoPipeline(rig, cfg, rectify=True).process_batch(lefts, rights)
    lr, rr = out["left_rectified"], out["right_rectified"]
    return sc.sgbm_cuda(torch.cat([lr, rr.flip(-1)]),
                        torch.cat([rr, lr.flip(-1)]), params,
                        apply_speckle=False).contiguous()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("speckle_tile_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    B, H, W, D = chip_smoke.MAIN
    disp = matcher_maps(B, H, W, D)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        srcs = variants(SRC.read_text())
        fns = {name: build(text, work, str(k))
               for k, (name, text) in enumerate(srcs.items())}
        names = list(fns)
        outs = {}

        def run(name):
            out = torch.empty(disp.shape, dtype=torch.int32, device="cuda")
            rc = fns[name](disp.data_ptr(), out.data_ptr(), *disp.shape,
                           2.0, kernels.stream())
            if rc:
                raise RuntimeError(f"sdr_speckle_labels ({name}): error {rc}")
            outs[name] = out

        times = {name: [] for name in names}
        stage_time(lambda: run(names[0]), args.reps)   # untimed: clocks up
        for name in names + names[::-1]:   # kept, other, other, kept
            ms = stage_time(lambda: run(name), args.reps)
            times[name].append(ms)
            print(f"K4 tiles [{card}]: {name} on {tuple(disp.shape)}: "
                  f"{ms:.4f} ms", flush=True)
        torch.cuda.synchronize()
        same = torch.equal(outs[names[0]], outs[names[1]])
        same_ref = torch.equal(outs[names[0]], sc.speckle_labels(disp, 2.0))
    print(f"K4 tiles [{card}]: " + ", ".join(
        f"{name} {sum(t) / len(t):.4f} ms" for name, t in times.items())
        + f"; labels equal: {same}, equal to the wrapper's: {same_ref}")
    if not (same and same_ref):
        raise SystemExit("speckle_tile_ab: the two tile shapes disagree")


if __name__ == "__main__":
    main()
