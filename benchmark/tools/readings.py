"""The two readings each check's limit is set between, for one cell, in one
process on the card:

- the program's: full runs of the cell (a short window at the cell's own
  load, then the check against the reference) on ``--seeds`` seeds from
  ``--base``; the lower reading of each number is the largest of these;
- the control's: the reference computed in bfloat16 in the program's
  place, on the checked pairs of ``--control-seeds`` further seeds,
  against the float32 reference; the upper reading is the smallest.

    python3 benchmark/tools/readings.py --workload <cell> --base <seed>
        [--seeds 12] [--control-seeds 3] [--seconds 1]

Prints one JSON line per seed and a summary line last. The benchmark's
own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import reference  # noqa: E402
from harness import cell as cell_mod, check, inputs  # noqa: E402


def control(cell, seed: int, device) -> dict:
    """The check's numbers with the bfloat16 reference standing in for the
    program, on the cell's number of checked pairs."""
    cfg = cell.config
    rig_m = inputs.rig(cfg["rig"])
    pool_l, pool_r = inputs.pool(rig_m, cfg, int(cell.traffic["pool"]),
                                 seed, device)
    pairs = sorted(np.random.default_rng([seed, 3]).choice(
        len(pool_l), int(cfg["check_pairs"]), replace=False).tolist())
    block = int(cfg["reference_block"])
    want = reference.run(pool_l[pairs], pool_r[pairs], rig_m, cfg, device,
                         block=block)
    got = reference.run(pool_l[pairs], pool_r[pairs], rig_m, cfg, device,
                        dt=torch.bfloat16, block=block)
    ref = {p: {k: v[i] for k, v in want.items()} for i, p in enumerate(pairs)}
    held = [(p, {k: v[i] for k, v in got.items() if k != "frame_stats"})
            for i, p in enumerate(pairs)]
    fetched = [(p, got["frame_stats"][i].cpu().numpy())
               for i, p in enumerate(pairs)]
    return check.compare(held, fetched, ref)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--base", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    cell = cell_mod.load(args.workload)
    dev = torch.device("cuda:0")
    program, ctrl = [], []
    for i in range(args.seeds):
        seed = args.base + i
        r = cell_mod.run(cell, seed, args.seconds, False, dev,
                         time.perf_counter(), lambda m: None)
        nums = {k: v["value"] for k, v in r["checks"].items()}
        program.append(nums)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": r["correct"], **nums}), flush=True)
    for i in range(args.control_seeds):
        seed = args.base + args.seeds + i
        nums = control(cell, seed, dev)
        ctrl.append(nums)
        print(json.dumps({"side": "control", "seed": seed, **nums}),
              flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(n[k] for n in program) for k in check.NAMES},
        "upper": {k: min(n[k] for n in ctrl) for k in check.NAMES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
