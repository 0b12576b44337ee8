"""K1's pair kernel at its two candidate tile widths, in turns (dev tool).

``cost_pair_strip_kernel`` (ops/csrc/cost_box.cu) owns TXP_PAIR output
columns per block, 16 or 32. This script builds cost_box.cu twice into a
temporary directory, once as it stands and once with the other width,
times both on the same Sobel images in the turns kept, other, other,
kept after one untimed turn (CUDA events, a warm-up call before each
turn), and checks that the two volumes are equal bit for bit. One line
per turn and a summary go to stdout, with the card's name and power
limit.

    python tools/pair_tile_ab.py                   # 8x720x1280x128, block 5
    python tools/pair_tile_ab.py --shape 1x1440x2560x256 --block 7

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

import numpy as np
import torch

from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
from stereo_depth_ruler_tpu_torch.utils import kernels
from stereo_depth_ruler_tpu_torch.utils.profiling import stage_time

SRC = kernels.CSRC_DIR / "cost_box.cu"
TXP = re.compile(r"constexpr int TXP_PAIR = (\d+);")


def build(src_text, work, tag):
    """A library holding only cost_box.cu's entry, from ``src_text``."""
    src = work / f"cost_box_{tag}.cu"
    src.write_text(src_text)
    lib = work / f"libpair_{tag}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sdr_cost_box
    fn.argtypes = kernels._SIGNATURES["sdr_cost_box"]
    fn.restype = ctypes.c_int
    return fn


def variants(text):
    """{name: source} for the kept width and the other one."""
    txp = int(TXP.search(text).group(1))
    return {f"TXP_PAIR {txp} (kept)": text,
            f"TXP_PAIR {48 - txp}": TXP.sub(
                f"constexpr int TXP_PAIR = {48 - txp};", text)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="8x720x1280x128",
                    help="BxHxWxD (default 8x720x1280x128)")
    ap.add_argument("--block", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    B, H, W, D = (int(v) for v in args.shape.split("x"))
    if not torch.cuda.is_available():
        raise SystemExit("pair_tile_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -(D // 3), axis=2)
                    + rng.normal(0, 2, left.shape), 0, 255).astype(np.float32)
    lt = plain.sobel_clip(torch.tensor(left, device="cuda"), 63).contiguous()
    rt = plain.sobel_clip(torch.tensor(right, device="cuda"), 63).contiguous()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        srcs = variants(SRC.read_text())
        fns = {name: build(text, work, str(k))
               for k, (name, text) in enumerate(srcs.items())}
        names = list(fns)
        outs = {}

        def run(name):
            out = torch.empty((2 * B, H, W, D), dtype=torch.int16,
                              device="cuda")
            rc = fns[name](lt.data_ptr(), rt.data_ptr(), out.data_ptr(), B,
                           H, W, D, 0, args.block, 1, kernels.stream())
            if rc:
                raise RuntimeError(f"sdr_cost_box ({name}): error {rc}")
            outs[name] = out

        times = {name: [] for name in names}
        stage_time(lambda: run(names[0]), args.reps)   # untimed: clocks up
        order = names + names[::-1]   # kept, other, other, kept
        for name in order:
            ms = stage_time(lambda: run(name), args.reps)
            times[name].append(ms)
            print(f"pair kernel [{card}]: {name} at {B}x{H}x{W}x{D} block "
                  f"{args.block}: {ms:.3f} ms", flush=True)
        torch.cuda.synchronize()
        same = {name: torch.equal(outs[names[0]], outs[name])
                for name in names[1:]}
    print(f"pair kernel [{card}]: " + ", ".join(
        f"{name} {sum(t) / len(t):.3f} ms" for name, t in times.items())
        + f"; volumes equal: {same}")
    if not all(same.values()):
        raise SystemExit("pair_tile_ab: the two widths disagree")


if __name__ == "__main__":
    main()
