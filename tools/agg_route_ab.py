"""The sweeps of csrc/tile_sgm.cu timed in turns on the card: their launch
plans against each other, or K9's sweeps against another tree's.

    python tools/agg_route_ab.py --plans [--reps N] [--shape BxHxWxD ...]
    python tools/agg_route_ab.py --k9 [--root DIR] [--reps N]

``--plans`` builds csrc/tile_sgm.cu once for each fixed launch plan of
``PLANS`` (the source's choosers ``columns_a_warp`` and ``up_plan``
rewritten to return constants, or its constants ``RING`` and ``TAIL``
set, linked with csrc/wta_lr.cu alone into a library of its own under
the package's ``_build/plans``): columns a path warp 1 or 2 for each up
plan (inline, the ring), the ring with 3 slots, and the chosen plans
with each pixel's WTA tail run alone (TAIL 1) rather than 32 rows at
once. At each shape it first prints each sweep's launch plan
(``sgbm_cuda.sweep_plan``: warps, blocks resident a multiprocessor,
frame slots, waves), the up sweep's inline and ring plans forced beside
the chosen one. On K1's int16 cost volume of B random-texture frames
(the right view the left one shifted by D // 3 with noise) it then times
the batch down sweep (``agg_down``) and up sweep with the WTA
(``sgbm_cuda._agg_up``, LR scatter on) of the package's own library
("chosen": its choosers decide) and of every fixed plan in turns (each,
then each again in reverse order; the mean of the two), each up sweep
labelled with the plan it ran (a ring that would take more waves than
the inline plan runs inline), at 1, 2, 4, 8 and 16 frames of
720x1280x128, 8 frames and one of 720x1280x256, one 1440x2560x256 frame,
one 720x1280x80 frame and 2 and 16 frames of 360x640x80 (or the shapes
given), and holds every plan's output to the chosen one's bit for bit.
A plan that cannot launch at a shape (shared memory past the card's) is
printed as such.

``--k9`` times K9's one-frame sweeps (``agg_down``, ``agg_horiz``,
``agg_up_wta`` with its LR pass, on a slab as K9 calls them, and
``sgbm_tile_cuda``) on a 1x720x1280x128 and a 1x1440x2560x256 slab;
``--root DIR`` imports the package from DIR (an unpacked checkout), so
that two trees are timed in turns, one process each. Every line names
the card and its power limit. It needs a CUDA card and nvcc.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def volume(B, H, W, D, params, seed=0):
    import numpy as np
    import torch
    from stereo_depth_ruler_tpu_torch.ops import sgbm as plain
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    right = np.clip(np.roll(left, -(D // 3), axis=2)
                    + rng.normal(0, 2, left.shape), 0, 255)
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(torch.tensor(left, device="cuda"), cap)
    rt = plain.sobel_clip(torch.tensor(right.astype(np.float32),
                                       device="cuda"), cap)
    return sc.cost_volume(lt, rt, params)


def in_turns(fns, reps):
    """ms per call of each fn, timed in the turns a, b, ..., b, a (mean of
    the two turns each)."""
    from stereo_depth_ruler_tpu_torch.utils.profiling import stage_time
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    ms = [0.0] * len(fns)
    for i in order:
        ms[i] += stage_time(fns[i], reps) / 2
    return ms


# Fixed launch plans: (label, the sweeps they fix, rewrites of tile_sgm.cu).
# A rewrite sets a chooser to return a constant (columns_a_warp: columns a
# path warp; up_plan: the up sweep's plan) or a constant to its value
# (RING: the ring's row slots; TAIL: the rows whose WTA tails a warp runs
# at once).
CONSTANTS = ("RING", "SBUF", "TAIL")
PLANS = [(f"cw {cw} inline", ("agg_down", "agg_up_wta"),
          {"columns_a_warp": cw, "up_plan": "PLAN_INLINE"})
         for cw in (1, 2)]
PLANS += [(f"cw {cw} ring", ("agg_up_wta",),
           {"columns_a_warp": cw, "up_plan": "PLAN_RING"}) for cw in (1, 2)]
PLANS += [("ring slots 3", ("agg_up_wta",),
           {"up_plan": "PLAN_RING", "RING": 3})]
PLANS += [("tail 1", ("agg_up_wta",), {"TAIL": 1})]


def rewrite(src, fixes):
    """tile_sgm.cu with each chooser of ``fixes`` returning its constant
    (or the constant set to its value); raises where one is not found."""
    for name, value in fixes.items():
        if name in CONSTANTS:
            src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", src)
        else:
            src, n = re.subn(rf"(int {name}\([^)]*\) \{{)[^}}]*\}}",
                             rf"\1 return {value}; }}", src)
        if n != 1:
            raise RuntimeError(f"tile_sgm.cu's {name} not found")
    return src


def build_plans():
    """A library of tile_sgm.cu (and wta_lr.cu, for the error strings) for
    each fixed plan of PLANS, every nvcc at once; returns the handles."""
    import ctypes
    from stereo_depth_ruler_tpu_torch.utils import kernels
    src = (kernels.CSRC_DIR / "tile_sgm.cu").read_text()
    nvcc = kernels._nvcc()
    compiles, links, libs = [], [], []
    for i, (_, _, fixes) in enumerate(PLANS):
        work = kernels.BUILD_DIR / "plans" / f"plan{i}"
        work.mkdir(parents=True, exist_ok=True)
        (work / "tile_sgm.cu").write_text(rewrite(src, fixes))
        objs = [work / "tile_sgm.o", work / "wta_lr.o"]
        compiles += [[nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(objs[0]),
                      str(work / "tile_sgm.cu")],
                     [nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(objs[1]),
                      str(kernels.CSRC_DIR / "wta_lr.cu")]]
        links.append([nvcc, *kernels._LINK_FLAGS, "-o",
                      str(work / "plan.so"), *map(str, objs)])
        libs.append(work / "plan.so")
    kernels._run_all(compiles)
    kernels._run_all(links)
    handles = []
    for path in libs:
        lib = ctypes.CDLL(str(path))
        for name, argtypes in kernels._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = kernels._RESTYPES.get(
                    name, ctypes.c_int)
        lib.sdr_error_string.argtypes = [ctypes.c_int]
        lib.sdr_error_string.restype = ctypes.c_char_p
        handles.append(lib)
    return handles


SHAPES = [(1, 720, 1280, 128), (2, 720, 1280, 128), (4, 720, 1280, 128),
          (8, 720, 1280, 128), (16, 720, 1280, 128), (1, 720, 1280, 256),
          (8, 720, 1280, 256), (1, 1440, 2560, 256), (1, 720, 1280, 80),
          (2, 360, 640, 80), (16, 360, 640, 80)]


def launch_plans(B, W, D, name):
    """Print the chosen plan of each sweep and the up sweep's inline and
    ring plans forced: warps, blocks a multiprocessor, slots, waves."""
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    for up, plan in ((False, None), (True, None), (True, "inline"),
                     (True, "ring")):
        p = sc.sweep_plan(up, B, W, D, plan)
        what = ("agg_up_wta" if up else "agg_down") + (
            f" {plan} forced" if plan else " chosen")
        print(f"agg_route_ab --plans [{name}] {B}x.x{W}x{D} {what}: "
              + ", ".join(f"{k} {v}" for k, v in p.items()), flush=True)


def plans(reps, name, shapes):
    import torch
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    from stereo_depth_ruler_tpu_torch.utils import kernels
    own = kernels.load()
    handles = build_plans()

    def on(lib, fn):
        def run():
            kernels._lib = lib
            try:
                return fn()
            finally:
                kernels._lib = own
        return run

    for B, H, W, D in shapes:
        launch_plans(B, W, D, name)
        params = SGBMParams(num_disparities=D, speckle_window_size=0)
        bias = sc.tile_bias(params)
        C = volume(B, H, W, D, params)
        S = sc.agg_down(C, params, bias)
        sc.agg_horiz(C, S, params)
        sweeps = {
            "agg_down": lambda: sc.agg_down(C, params, bias),
            "agg_up_wta": lambda: sc._agg_up(C, S, params, bias, True, B,
                                             H)[0],
        }
        for sweep, fn in sweeps.items():
            want, got = fn(), None
            runs, labels = [fn], ["chosen"]
            for (label, fixed, _), lib in zip(PLANS, handles):
                if sweep not in fixed:
                    continue
                before = dict(sc.UP_WTA_PLANS)
                try:
                    got = on(lib, fn)()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"agg_route_ab --plans [{name}] {B}x{H}x{W}x{D} "
                          f"{sweep} {label}: does not launch ({e})",
                          flush=True)
                    continue
                if not torch.equal(got, want):
                    raise AssertionError(f"{sweep} {label} at "
                                         f"{B}x{H}x{W}x{D}: output differs")
                ran = [k for k, v in sc.UP_WTA_PLANS.items()
                       if v != before[k]]
                runs.append(on(lib, fn))
                if sweep == "agg_down":
                    label = label.replace(" inline", "")
                labels.append(label + (f" (ran {ran[0]})" if ran else ""))
            del got
            ms = in_turns(runs, reps)
            best = min(ms)
            for label, t in zip(labels, ms):
                print(f"agg_route_ab --plans [{name}] {B}x{H}x{W}x{D} "
                      f"{sweep} {label}: {t:.4f} ms ({t / best:.3f}x the "
                      "fastest)", flush=True)
        del C, S
        torch.cuda.empty_cache()


def k9(reps, name):
    from stereo_depth_ruler_tpu_torch import SGBMParams
    from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
    for H, W, D in ((720, 1280, 128), (1440, 2560, 256)):
        params = SGBMParams(num_disparities=D, speckle_window_size=0)
        C = volume(1, H, W, D, params)
        bias = sc.tile_bias(params)
        S = sc.agg_down(C, params, bias)
        # the horizontal sweep timed on a copy it adds into over and over;
        # the up sweep on S_dh with both horizontal paths added once
        S_h = S.clone()
        sc.agg_horiz(C, S, params)
        fns = {"agg_down": lambda: sc.agg_down(C, params, bias),
               "agg_horiz": lambda: sc.agg_horiz(C, S_h, params),
               "agg_up_wta+lr": lambda: sc.agg_up_wta(C, S, params, bias),
               "sgbm_tile": lambda: sc.sgbm_tile_cuda(C, params)}
        for k, fn in fns.items():
            ms = in_turns([fn], reps)[0]
            print(f"agg_route_ab --k9 [{name}] 1x{H}x{W}x{D}: {k} {ms:.4f} "
                  "ms", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--plans", action="store_true")
    mode.add_argument("--k9", action="store_true")
    ap.add_argument("--root", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shape", action="append", default=[],
                    help="BxHxWxD (repeatable; --plans' own list if none)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root or Path(__file__).resolve()
                                .parent.parent).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("agg_route_ab: needs a CUDA card")
    name = card()
    if args.k9:
        k9(args.reps, name)
    else:
        shapes = ([tuple(int(v) for v in sh.split("x")) for sh in args.shape]
                  if args.shape else SHAPES)
        plans(args.reps, name, shapes)


if __name__ == "__main__":
    main()
