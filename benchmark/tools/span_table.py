"""A traced run of one cell, then what the program's stage spans read in
its trace: the device operations and device time under each span, the
requests' idle time split by span beside device_idle_pct.live's total,
and the check that the spans share the device's clock.

    python3 benchmark/tools/span_table.py --workload <cell> --seed <n>
        [--seconds 20]

Runs benchmark/run.py's ``main`` with ``--trace 1`` (its result line and
log as they are), then prints one JSON line of the table. On a program
without the spans the table holds the clock check alone. The benchmark's
own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import run  # noqa: E402
from harness import spans, trace as tr  # noqa: E402


def _key(name):
    return "outside" if name is spans.OUTSIDE else name


def table(t: tr.Trace) -> dict:
    calls = len(t.calls)
    frames = sum(c.frames for c in t.calls)
    leads = spans.launch_leads(t)
    out = {"calls": calls, "frames": frames,
           "clock": {"device_ops": len(t.device), "with_launch": len(leads),
                     "share_at_or_after": (sum(d >= 0 for d in leads)
                                           / len(leads) if leads else None),
                     "min_lead_us": min(leads) if leads else None}}
    sp = spans.read(t)
    if sp is None:
        out["spans"] = None
        return out
    ops = spans.ops_by_span(t, sp)
    out["ops_per_call"] = {_key(k): len(v) / calls for k, v in ops.items()}
    out["device_ms_per_frame"] = {_key(k): sum(o.dur for o in v) * 1e-3
                                  / frames for k, v in ops.items()}
    out["call_host_ms_per_call"] = sum(o.dur for o in sp.calls) * 1e-3 \
        / calls
    req = [c for c in t.calls if c.request is not None]
    if req:
        n = len(req)
        idle = spans.request_idle(t, sp)
        length = sum(c.request[1] - c.request[0] for c in req)
        busy = sum(b - a for c in req for a, b in tr.merged(c.ops))
        out["idle_ms_per_request"] = {_key(k): v * 1e-3 / n
                                      for k, v in idle.items()}
        out["request_ms"] = length * 1e-3 / n
        out["idle_pct"] = 100.0 * (1.0 - busy / length)
        out["idle_sum_ms"] = sum(idle.values()) * 1e-3 / n
        out["idle_pct_x_request_ms"] = out["idle_pct"] / 100.0 \
            * out["request_ms"]
        shifts = sorted(spans.shift(c, sp.launch) for c in req)
        out["request_shift_us"] = {"min": shifts[0],
                                   "median": shifts[n // 2],
                                   "max": shifts[-1]}
        out["requests_spilling"] = sum(
            max(o.end for o in spans.aligned(c, sp.launch)) > c.request[1]
            for c in req if c.ops)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    kept = []
    build = tr.build

    def keep(*a):
        kept.append(build(*a))
        return kept[-1]

    tr.build = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not kept:
        return rc or 1
    print(json.dumps({"span_table": args.workload, **table(kept[0])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
