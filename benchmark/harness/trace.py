"""The reduction of a torch.profiler trace to what the per-layer metrics
read.

The traced run wraps the measured window in ``torch.profiler.profile``
(CPU and CUDA activities) and marks the generator's own steps with
``record_function`` spans (``bench.window``, ``bench.submit``,
``bench.fetch``, ``bench.request``, ``bench.sleep``). The profiler's
Chrome trace holds the device operations (kernels, copies, sets, each with
the correlation id of the runtime call that issued it) and the host's
events. A device operation belongs to the call whose ``bench.submit`` or
``bench.fetch`` span issued it.

Within a call, on one stream, the device operations run in order. The
matcher's and the WLS filter's kernels are found by the names in
``roofline/sgbm.py`` and ``roofline/wls.py``; host-to-device copies are the
upload; the other operations before the first matcher kernel are the
preparation (gray, rectify, downscale, the pair's stacking, the Sobel
prefilter) and those after the last matcher or WLS kernel the
post-processing (the WLS ratio, reprojection, stats). Times are in
microseconds, as the trace gives them.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    ts: float
    dur: float
    corr: Optional[int] = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class CallTrace:
    frames: int
    request: Optional[Tuple[float, float]]   # open loop: wake to done
    ops: List[Op]          # device operations, in start order


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Op]       # every device operation in the window
    calls: List[CallTrace]
    host: List[Op]         # the main thread's host events


def export(prof) -> list:
    """The profiler's Chrome trace events, through a file in the temporary
    directory that is removed again."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _ops(events, cats) -> List[Op]:
    out = [Op(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0)),
              (e.get("args") or {}).get("correlation"))
           for e in events if e.get("ph") == "X" and e.get("cat") in cats]
    out.sort(key=lambda o: o.ts)
    return out


def build(events: list, frames_per_call: List[int]) -> Trace:
    """A Trace from Chrome trace events and each call's frame count, in
    the order the calls were submitted."""
    annots = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    win = [e for e in annots if e["name"] == "bench.window"]
    if len(win) != 1:
        raise ValueError(f"expected one bench.window span, found {len(win)}")
    main_tid = win[0]["tid"]
    lo = float(win[0]["ts"])
    window = (lo, lo + float(win[0]["dur"]))
    host = _ops([e for e in events if e.get("tid") == main_tid], HOST_CATS)
    device = [o for o in _ops(events, DEVICE_CATS)
              if o.end > window[0] and o.ts < window[1]]
    launch = {o.corr: o.ts for o in _ops(events, RUNTIME_CATS)
              if o.corr is not None}

    def spans(name):
        return [(o.ts, o.end) for o in host if o.name == name]

    submits, fetches = spans("bench.submit"), spans("bench.fetch")
    requests = spans("bench.request")
    if len(submits) != len(frames_per_call) or len(fetches) != len(submits):
        raise ValueError(f"{len(submits)} submit and {len(fetches)} fetch "
                         f"spans for {len(frames_per_call)} calls")
    # every span of a call, by start time, to the call's index
    owners = sorted([(a, b, i) for i, (a, b) in enumerate(submits)]
                    + [(a, b, i) for i, (a, b) in enumerate(fetches)])
    starts = [s[0] for s in owners]
    per_call: Dict[int, List[Op]] = defaultdict(list)
    for o in device:
        t = launch.get(o.corr)
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= owners[k][1]:
            per_call[owners[k][2]].append(o)
    calls = [CallTrace(n, requests[i] if requests else None, per_call[i])
             for i, n in enumerate(frames_per_call)]
    return Trace(window, device, calls, host)


def merged(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, as sorted disjoint ones."""
    out: List[List[float]] = []
    for o in sorted(ops, key=lambda o: o.ts):
        if out and o.ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.ts, o.end])
    return [(a, b) for a, b in out]


def covered(busy: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of [lo, hi] that the disjoint sorted intervals cover."""
    k = max(bisect.bisect_right(busy, lo, key=lambda iv: iv[0]) - 1, 0)
    total = 0.0
    while k < len(busy) and busy[k][0] < hi:
        a, b = busy[k]
        total += max(0.0, min(b, hi) - max(a, lo))
        k += 1
    return total


def busy_us(trace: Trace) -> float:
    return covered(merged(trace.device), *trace.window)


def stages(call: CallTrace, matcher, wls) -> Dict[str, float]:
    """Device microseconds of one call by stage: upload, prep, matcher, wls,
    post, and other (copies to the host, and what runs between the
    matcher's first and the WLS filter's last kernel outside either)."""
    ops = call.ops
    tagged = [("upload" if o.cat == "gpu_memcpy" and "HtoD" in o.name else
               "matcher" if matcher.search(o.name) else
               "wls" if wls.search(o.name) else None) for o in ops]
    named = [i for i, t in enumerate(tagged) if t in ("matcher", "wls")]
    first_m = next((i for i, t in enumerate(tagged) if t == "matcher"), None)
    last = named[-1] if named else None
    out = dict.fromkeys(("upload", "prep", "matcher", "wls", "post", "other"),
                        0.0)
    for i, (o, t) in enumerate(zip(ops, tagged)):
        if t is None:
            if o.cat == "gpu_memcpy":
                t = "other"
            elif first_m is not None and i < first_m:
                t = "prep"
            elif last is not None and i > last:
                t = "post"
            else:
                t = "other"
        out[t] += o.dur
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name).strip()


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, and the device's
    idle time in the window by what the host was doing then (the
    outermost and the innermost host event at the middle of each gap)."""
    by_op: Dict[str, float] = defaultdict(float)
    for o in trace.device:
        by_op[_short(o.name)[:120]] += o.dur * 1e-6
    gaps = []
    prev = trace.window[0]
    for a, b in merged(trace.device):
        if a > prev:
            gaps.append((prev, min(a, trace.window[1])))
        prev = max(prev, b)
    if prev < trace.window[1]:
        gaps.append((prev, trace.window[1]))
    by_host: Dict[str, float] = defaultdict(float)
    for (a, b), chain in zip(gaps, _host_at([(a + b) / 2 for a, b in gaps],
                                            trace.host)):
        chain = [n for n in chain if n != "bench.window"]
        label = " > ".join(dict.fromkeys([chain[0], chain[-1]])) \
            if chain else "(no host event)"
        by_host[label[:160]] += (b - a) * 1e-6
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                key=lambda kv: -kv[1])[:top]}


def _host_at(points: List[float], host: List[Op]) -> List[List[str]]:
    """For each point (ascending), the names of the host events covering
    it, outermost first: one sweep with a stack of nested events."""
    out, stack, k = [], [], 0
    for p in points:
        while k < len(host) and host[k].ts <= p:
            while stack and stack[-1].end <= host[k].ts:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1].end <= p:
            stack.pop()
        out.append([o.name for o in stack if o.ts <= p < o.end])
    return out


def stage_sums(trace: Trace, matcher, wls) -> Dict[str, float]:
    """``stages`` summed over every call of the trace, with ``frames``, the
    frames of those calls."""
    out = dict.fromkeys(("upload", "prep", "matcher", "wls", "post", "other"),
                        0.0)
    for call in trace.calls:
        for k, v in stages(call, matcher, wls).items():
            out[k] += v
    out["frames"] = sum(c.frames for c in trace.calls)
    return out
