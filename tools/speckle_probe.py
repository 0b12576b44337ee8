"""Where K4's and K5's time goes inside their launches (dev tool).

On the full path's 16 matcher maps before the speckle filter (as
tools/speckle_tile_ab.py builds them) and on 16 noisy 720x1280 maps
(chip_smoke.py's _noisy_disp: many small components), this script builds
instrumented copies of ops/csrc/speckle.cu into a temporary directory and
prints:

- for ``labels_tiles`` and ``keep_count``, the mean clock64 cycles per
  block between consecutive barriers (thread 0 of each block, summed over
  the launch with an atomicAdd into a device counter; the copy is built
  for this and changes no result);
- the number of in-tile unions (a counter in a copy of ``labels_tiles``)
  and, after the border unions, the mean and largest number of steps from
  a pixel's label to its root;
- K4's three launches timed as they stand and with the resolve's walk
  reading through ``volatile`` (ld.volatile.global), which is how the
  unions read in the parent's kernel;

each line with the card's name and power limit.

    python tools/speckle_probe.py

It needs a CUDA card and nvcc.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch

import chip_smoke
from speckle_tile_ab import matcher_maps
from stereo_depth_ruler_tpu_torch.utils import kernels
from stereo_depth_ruler_tpu_torch.utils.profiling import stage_time

SRC = (kernels.CSRC_DIR / "speckle.cu").read_text()
COUNTERS = """namespace {
__device__ unsigned long long probe[9];
"""
READ = """
extern "C" int probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, probe, sizeof(probe));
  const unsigned long long zero[9] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(probe, zero, sizeof(zero));
  return (int)e;
}
"""
UNITE = "    unite<false>(ls, i, i - TW);\n"
RESOLVE = "__device__ __forceinline__ int find_root(const int* L, int x) {"


def timed_barriers(src, kernel):
    """The source with thread 0 of each block of ``kernel`` adding the
    cycles since its last barrier into probe[site] at every barrier, the
    rest into the last site, and 1 into probe[8]; and the sites' count."""
    lines = src.split("\n")
    a = next(i for i, line in enumerate(lines)
             if line.startswith(kernel + "("))
    b = next(i for i in range(a, len(lines)) if lines[i] == "}")
    body = lines[a:b + 1]
    head = next(i for i, line in enumerate(body) if line.endswith("{"))
    body.insert(head + 1, "  long long t_prev = clock64();")
    out, site = [], 0
    for line in body:
        out.append(line)
        if line.strip().startswith("__syncthreads();"):
            out.append(f"if (threadIdx.x == 0) {{ const long long t = "
                       f"clock64(); atomicAdd(&probe[{site}], "
                       f"(unsigned long long)(t - t_prev)); t_prev = t; }}")
            site += 1
    out.insert(len(out) - 1, f"if (threadIdx.x == 0) {{ atomicAdd(&probe["
                             f"{site}], (unsigned long long)(clock64() - "
                             f"t_prev)); atomicAdd(&probe[8], 1ull); }}")
    lines[a:b + 1] = out
    return "\n".join(lines), site + 1


def variants():
    """{name: (source, barrier sites)} of the instrumented copies."""
    assert COUNTERS.split("\n")[0] + "\n" in SRC and UNITE in SRC
    assert RESOLVE in SRC
    base = SRC.replace("namespace {\n", COUNTERS, 1)
    out = {name: timed_barriers(base, name)
           for name in ("labels_tiles", "keep_count")}
    out["unions"] = (base.replace(UNITE, "    atomicAdd(&probe[0], 1ull);\n"
                                  + UNITE), 0)
    out["volatile resolve"] = (base.replace(RESOLVE, RESOLVE.replace(
        "const int* L", "const volatile int* L")), 0)
    out["as it stands"] = (base, 0)
    return {name: (text + READ, sites) for name, (text, sites) in out.items()}


def build(text, work, tag):
    src = work / f"speckle_{tag}.cu"
    src.write_text(text)
    lib = work / f"libspeckle_{tag}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib))
    for name in ("sdr_speckle_labels_part", "sdr_speckle_keep_part"):
        getattr(lib, name).argtypes = kernels._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_read.restype = ctypes.c_int
    return lib


def steps_to_root(labels):
    """(mean, max) steps from each valid pixel's label to its root."""
    B = labels.shape[0]
    n = labels[0].numel()
    parent = labels.reshape(B, n).long()
    cur = parent.clone()
    valid = cur < n
    steps = torch.zeros_like(cur)
    while True:
        nxt = torch.where(valid, torch.gather(parent, 1, cur.clamp(max=n - 1)),
                          cur)
        moved = valid & (nxt != cur)
        if not moved.any():
            break
        steps += moved.long()
        cur = nxt
    s = steps[valid].double()
    return float(s.mean()), int(s.max())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("speckle_probe: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    B, H, W, D = chip_smoke.MAIN
    maps = {"full path": matcher_maps(B, H, W, D),
            "noisy": torch.tensor(chip_smoke._noisy_disp(2 * B, H, W, 3),
                                  device="cuda")}
    buf = (ctypes.c_ulonglong * 9)()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: (build(text, Path(tmp), str(k)), sites)
                for k, (name, (text, sites)) in enumerate(variants().items())}
        for mname, disp in maps.items():
            Bm, Hm, Wm = disp.shape
            labels = torch.empty(disp.shape, dtype=torch.int32, device="cuda")
            sizes = torch.empty((Bm, Hm * Wm + 1), dtype=torch.int32,
                                device="cuda")
            out = torch.empty_like(disp)

            def k4(lib, part):
                kernels.check(lib.sdr_speckle_labels_part(
                    disp.data_ptr(), labels.data_ptr(), Bm, Hm, Wm, 2.0, part,
                    kernels.stream()), "speckle_labels part")

            def k5(lib, part):
                kernels.check(lib.sdr_speckle_keep_part(
                    disp.data_ptr(), labels.data_ptr(), sizes.data_ptr(),
                    out.data_ptr(), Bm, Hm, Wm, 200, part, kernels.stream()),
                    "speckle_keep part")

            tag = f"speckle probe [{card}] {mname} {tuple(disp.shape)}"
            for name in ("labels_tiles", "keep_count"):
                lib, sites = libs[name]
                for k in range(3):
                    k4(libs["as it stands"][0], k)
                lib.probe_read(buf)
                (k4 if name == "labels_tiles" else k5)(lib, 0)
                torch.cuda.synchronize()
                lib.probe_read(buf)
                per = ", ".join(f"{buf[s] / buf[8]:.0f}" for s in range(sites))
                print(f"{tag}: {name} cycles per block between barriers "
                      f"({buf[8]} blocks): {per}", flush=True)
            lib = libs["unions"][0]
            lib.probe_read(buf)
            k4(lib, 0)
            torch.cuda.synchronize()
            lib.probe_read(buf)
            k4(lib, 1)
            torch.cuda.synchronize()
            mean, top = steps_to_root(labels)
            print(f"{tag}: {buf[0]} unions in tiles; after the borders "
                  f"{mean:.3f} steps to the root on average, {top} at most",
                  flush=True)
            for name in ("as it stands", "volatile resolve"):
                lib = libs[name][0]
                t = [stage_time(lambda: [k4(lib, k) for k in range(p + 1)], 10)
                     for p in range(3)]
                print(f"{tag}: {name}: tiles {t[0]:.4f}, borders "
                      f"{t[1] - t[0]:.4f}, resolve {t[2] - t[1]:.4f}, K4 "
                      f"{t[2]:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
