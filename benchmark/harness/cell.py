"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell is an entry of BENCHMARK.json's ``workloads``. Everything it needs
is found by name: the configuration's file (BENCHMARK.json's ``configs``),
its driver ``drivers/<driver>.py`` (the configuration's ``"driver"``,
``"pipeline"`` where it names none), which builds the program, calls it,
fetches and holds its outputs and gives the numbers its check compares,
``traffic/<traffic>.json`` and, for every metric the run reports,
``metrics/<metric>.py``, whose ``read(run)`` returns the metric's value or
None where the run has nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from harness import check, inputs, trace as tr, traffic

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DRIVERS = BENCH / "drivers"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, with its configuration,
    traffic and the metric entries it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg_file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg_file).read_text())
    trf = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name, int(w["chips"]), config, trf, e2e, per_layer)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable:
    """``read`` of metrics/<metric>.py."""
    return _module(BENCH / "metrics" / f"{metric}.py", "metric_" + metric).read


def driver(name: str):
    """drivers/<name>.py as a module (drivers/__init__.py says what it
    gives)."""
    return _module(DRIVERS / f"{name}.py", "driver_" + name)


@dataclasses.dataclass
class Measured:
    """What a metric's reader gets."""
    config: dict
    traffic: dict
    seconds: float
    t0: float                        # the window's start, host clock
    calls: List[traffic.Call]
    setup_s: float
    peak_bytes: int
    trace: Optional[tr.Trace] = None


def _entry_taken(drv, name: str, entry: str, batch: int) -> None:
    """Raises ValueError unless the driver takes ``entry`` at ``batch``."""
    sizes = drv.ENTRIES.get(entry, ())
    if sizes is None or batch in sizes:
        return
    took = ", ".join(
        f"{e} at batch {'any' if b is None else '/'.join(map(str, b))}"
        for e, b in drv.ENTRIES.items())
    raise ValueError(f"driver {name!r} takes no entry {entry!r} at batch "
                     f"{batch}; it takes {took}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev) -> str:
    """The card's name and power limit, for the record."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, log: Callable[[str], None],
        wrap: Optional[Callable] = None) -> dict:
    """One run: returns the result object, ``checks`` last. ``t_start`` is
    the host clock at the process's start, from which set-up counts.
    ``wrap(program)``, where given, stands in for the program (tests
    plant faults with it)."""
    dev = torch.device(device)
    cfg, trf = cell.config, cell.traffic
    drv_name = cfg.get("driver", "pipeline")
    drv = driver(drv_name)
    batch = int(trf["batch"])
    _entry_taken(drv, drv_name, trf["entry"], batch)
    parts = {"import_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    rig_m = inputs.rig(cfg["rig"])
    n_pool = int(trf["pool"])
    pool = inputs.pool(rig_m, cfg, n_pool, seed, dev)
    parts["render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    program = drv.build(cfg, rig_m, dev)
    if wrap is not None:
        program = wrap(program)
    parts["pipeline_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        # a checkout's first run builds the kernels (nvcc): timed apart
        from stereo_depth_ruler_tpu_torch.utils import kernels
        if kernels.status() == "not built":
            t = time.perf_counter()
            kernels.build()
            parts["build_s"] = time.perf_counter() - t

    seq = traffic.order(n_pool, int(trf["distinct"]) * batch, seed)
    used = np.unique(seq)
    checked = np.random.default_rng([seed % (1 << 64), 3]).choice(
        used, min(int(cfg["check_pairs"]), len(used)), replace=False)
    holder = drv.holder(trf["entry"], checked, seed)
    call_program = drv.call(program, trf["entry"], pool, seq, batch)

    def submit(call):
        out = call_program(call.slot, call.pairs)
        holder.offer(call.pairs, out)
        return out

    n_slots = len(seq) // batch
    for i in range(int(trf["warmup"])):
        t = time.perf_counter()
        out = call_program(i % n_slots, seq[(i % n_slots) * batch:][:batch])
        drv.fetch(out)
        _sync(dev)
        parts[f"warmup{i}_s"] = time.perf_counter() - t
    holder.prepare(out)
    del out
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    log("setup " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f}")

    prof = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        span = record_function
    else:
        def span(name):
            return nullcontext()
    with prof if prof is not None else nullcontext():
        with span("bench.window"):
            t0, calls = traffic.run(trf, seconds, submit, drv.fetch, seq,
                                    span=span)
            _sync(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    measured = Measured(cfg, trf, seconds, t0, calls, setup_s, peak)
    if trf["mode"] == "open":
        late = np.array([c.lateness for c in calls]) * 1e3
        log(f"generator lateness ms: p50 {np.percentile(late, 50):.4f} "
            f"p95 {np.percentile(late, 95):.4f} max {late.max():.4f} over "
            f"{len(calls)} requests")
    lat = np.array([c.latency for c in calls]) * 1e3
    log(f"window: {len(calls)} calls, {sum(len(c.pairs) for c in calls)} "
        f"frames, peak {peak} bytes; call latency ms p50 "
        f"{np.percentile(lat, 50):.4f} p90 {np.percentile(lat, 90):.4f} p99 "
        f"{np.percentile(lat, 99):.4f} max {lat.max():.4f}")

    held = holder.frames()
    mine = {int(p) for p in checked}
    fetched = [(int(p), c.stats[k]) for c in calls
               for k, p in enumerate(c.pairs) if int(p) in mine]
    del program, holder, submit, call_program
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if not held:
        raise RuntimeError("the window produced no frame of a checked pair")
    numbers = drv.compare(held, fetched, pool, rig_m, cfg, dev)
    ok, table = check.judge(numbers, cfg["limits"])
    missing = sum(1 for c in calls if c.stats is None)
    log(f"reference: {len(held)} pairs in {time.perf_counter() - t:.3f} s; "
        f"{len(fetched)} fetched stats compared")

    result = {"correct": bool(ok and missing == 0),
              "attempted": sum(len(c.pairs) for c in calls),
              "failed": missing, "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak},
              "card": card(dev), "setup_parts": parts}
    specs = cell.per_layer if trace_on else cell.end_to_end
    if trace_on:
        t = time.perf_counter()
        measured.trace = tr.build(tr.export(prof),
                                  [len(c.pairs) for c in calls])
        busy = tr.busy_us(measured.trace)
        window = measured.trace.window[1] - measured.trace.window[0]
        result["device"].update(busy_s=busy * 1e-6, window_s=window * 1e-6)
        result["breakdown"] = tr.breakdown(measured.trace)
        log(f"trace: {len(measured.trace.device)} device ops, busy "
            f"{busy * 1e-6:.6f} of {window * 1e-6:.6f} s, read in "
            f"{time.perf_counter() - t:.3f} s")
    for m in specs:
        value = reader(m["name"])(measured)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["checks"] = table
    return result
