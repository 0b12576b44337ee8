"""Where the sorted-run kernel's time goes, against another tree's (dev
tool).

On the K4 labels of the full path's 16 matcher maps before the speckle
filter (16 x 2^20 packed keys, as tools/speckle_tile_ab.py builds the
maps), pair-sorted with their positions, this script builds
ops/csrc/sorted_runs.cu alone into a temporary directory, and with
``--parent DIR`` the sorted_runs.cu of the checkout in DIR (an unpacked
parent commit, say) beside it, and with ``--passes P ...`` copies of this
tree's source with P passes of 32 positions a warp (a tile of 256 P
positions) instead of its own. It prints each library's registers and spills
per kernel and, each output held bitwise against ops/sort.py:

- run sizes three ways: (a) the real sorted keys and source indices,
  (b) no source indices, so the stores are coalesced, (c) all keys
  distinct, so no run crosses a tile edge; (a) - (b) is the scatter's
  cost, (a) - (c) the tile-edge searches';
- the keep bytes (max_size 200) and the large-run roots (L = 1024,
  max_size 200);

each timed with CUDA events in the turns parent, this tree, this tree,
parent (and this tree against each --passes copy the same way), beside
its byte bound, on the card named in every line.

    python tools/sorted_runs_probe.py [--parent DIR] [--passes 16 32]

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
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch

import chip_smoke
from speckle_tile_ab import matcher_maps
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.ops import sort as splain
from stereo_depth_ruler_tpu_torch.ops import sort_cuda as soc
from stereo_depth_ruler_tpu_torch.utils import kernels
from stereo_depth_ruler_tpu_torch.utils.profiling import stage_time

REL = Path("stereo_depth_ruler_tpu_torch/ops/csrc/sorted_runs.cu")
PASSES = re.compile(r"constexpr int PASSES = \d+;")
SIZES, KEEP, ROOTS = 0, 1, 2


def build(text, work, tag):
    """(the library built from ``text`` alone, its ptxas lines per
    kernel)."""
    src = work / f"sorted_runs_{tag}.cu"
    src.write_text(text)
    lib = work / f"libsorted_runs_{tag}.so"
    log = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          "-o", str(lib), str(src)], check=True,
                         capture_output=True, text=True)
    regs = chip_smoke.ptxas_named(log.stdout + log.stderr,
                                  r"(runs_sizes|runs_roots)(?:ILi(\d)E)?")
    lib = ctypes.CDLL(str(lib))
    lib.sdr_sorted_runs.argtypes = kernels._SIGNATURES["sdr_sorted_runs"]
    lib.sdr_sorted_runs.restype = ctypes.c_int
    return lib, regs


def runs(lib, skey, sidx, out, mode, max_size=0, L=1, slots=0):
    """One launch of ``lib``'s sdr_sorted_runs; returns ``out``."""
    B, N = skey.shape[0], skey[0].numel()
    rc = lib.sdr_sorted_runs(
        skey.data_ptr(), None if sidx is None else sidx.data_ptr(),
        out.data_ptr(), B, N, out[0].numel(), mode, max_size, L, slots,
        kernels.stream())
    if rc:
        raise RuntimeError(f"sdr_sorted_runs: CUDA error {rc}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose sorted_runs.cu to "
                    "time against this tree's")
    ap.add_argument("--passes", type=int, nargs="*", default=[],
                    help="also time copies with these many passes a warp")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sorted_runs_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    B, H, W, D = chip_smoke.MAIN
    labels = sc.speckle_labels(matcher_maps(B, H, W, D), 2.0)
    key, n, n2, L, R = splain.pack_batched(labels)
    Bk = key.shape[0]
    skey, sidx = soc.sort_pairs(key, splain.positions(key))
    skey, sidx = skey.reshape(Bk, n2), sidx.reshape(Bk, n2)
    distinct = splain.positions(skey)
    max_size, keys = 200, Bk * n2
    slots = splain.roots_slots(L, max_size)
    sizes_n = torch.empty((Bk, n), dtype=torch.int32, device="cuda")
    sizes_2 = torch.empty((Bk, n2), dtype=torch.int32, device="cuda")
    keep = torch.empty((Bk, n), dtype=torch.bool, device="cuda")
    roots = torch.empty((Bk, R, slots), dtype=torch.int32, device="cuda")
    # name -> (launch on a library, the plain output, bytes)
    cases = {
        "(a) sizes, keys and sidx": (
            lambda lib: runs(lib, skey, sidx, sizes_n, SIZES),
            splain.run_sizes(skey, sidx, n), 8 * keys + 4 * Bk * n),
        "(b) sizes, no sidx": (
            lambda lib: runs(lib, skey, None, sizes_2, SIZES),
            splain.run_sizes(skey), 8 * keys),
        "(c) sizes, distinct keys": (
            lambda lib: runs(lib, distinct, sidx, sizes_n, SIZES),
            splain.run_sizes(distinct, sidx, n), 8 * keys + 4 * Bk * n),
        "keep": (
            lambda lib: runs(lib, skey, sidx, keep, KEEP, max_size),
            splain.run_keep(skey, sidx, n, max_size), 8 * keys + Bk * n),
        "roots": (
            lambda lib: runs(lib, skey, None, roots, ROOTS, max_size, L,
                             slots),
            splain.large_run_roots(skey, n2, L, max_size),
            4 * keys + 4 * Bk * R * slots),
    }
    here = (kernels.CSRC_DIR / "sorted_runs.cu").read_text()
    texts = {"this tree": here}
    if args.parent:
        texts["parent"] = (Path(args.parent) / REL).read_text()
    for p in args.passes:
        assert PASSES.search(here)
        texts[f"{p} passes"] = PASSES.sub(f"constexpr int PASSES = {p};",
                                          here)
    tag = f"sorted_runs probe [{card}] {Bk}x{n2} keys"
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for k, (name, text) in enumerate(texts.items()):
            libs[name], regs = build(text, Path(tmp), str(k))
            print(f"{tag}: {name}: {', '.join(regs)}", flush=True)
        for case, (fn, want, nbytes) in cases.items():
            for name, lib in libs.items():
                got = fn(lib)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}: {case} differs from "
                                         f"ops/sort.py")
        bound_ms = {case: chip_smoke.bound(c[2], 0)[0]
                    for case, c in cases.items()}
        for other in [o for o in libs if o != "this tree"]:
            for case, (fn, _, _) in cases.items():
                turns = {other: [], "this tree": []}
                for name in (other, "this tree", "this tree", other):
                    turns[name].append(stage_time(
                        lambda: fn(libs[name]), args.reps))
                print(f"{tag}: {case}: this tree "
                      + " / ".join(f"{t:.4f}" for t in turns["this tree"])
                      + f" ms, {other} "
                      + " / ".join(f"{t:.4f}" for t in turns[other])
                      + f" ms, bound {bound_ms[case]:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
