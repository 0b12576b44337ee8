"""The port's benchmark: one run of one cell on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell, its configuration, driver, traffic
and metrics are found by name (BENCHMARK.json, benchmark/configs,
benchmark/drivers, benchmark/traffic, benchmark/metrics). The run renders
its inputs from the seed, has the configuration's driver build the program
(of stereo_depth_ruler_tpu_torch), warms it up on the cell's own shapes,
drives it for ``--seconds`` with the cell's traffic, then checks a seeded
sample of what the window produced against the driver's plain reference
(benchmark/reference). With ``--trace 0`` it reports
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
read from a torch.profiler trace of the window.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``; ``checks`` last). The numbers compared, each beside its
limit, are also the last lines of standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it exits 2 and prints no result;
if JAX or the JAX package was loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_depth_ruler_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    import stereo_depth_ruler_tpu_torch  # noqa: F401  (the system under test)
    from harness import cell as cell_mod

    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, found "
            f"{torch.cuda.device_count()}")
        return 2
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T_START, log)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
