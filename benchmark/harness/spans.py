"""The program's own stage spans in a traced run.

While a torch profiler records, ``StereoPipeline`` (pipeline.py of the
port) wraps each ``process_pair`` / ``process_batch`` call in a
``record_function`` span ``sdr.call`` that holds, in order and apart,
``sdr.upload``, ``sdr.prep``, ``sdr.matcher``, ``sdr.wls`` (with WLS only)
and ``sdr.post``. They are host events of the main thread, on the
profiler's clock, so ``Trace.host`` holds them beside the runtime calls.
Every ``sdr.*`` span is read; one that ``LAYER`` does not name (another
program's stage, such as ``sdr.voxel``) is of the layer named after
``sdr.`` (``voxel``).

- A device operation belongs to the innermost ``sdr.*`` span open at the
  host start of the runtime call that launched it (the correlation id of
  the runtime events in ``Trace.host``).
- A request's device idle time is what ``device_idle_pct.live`` counts:
  the request's ``bench.request`` interval less the union of its own
  device operations. It is split instant by instant by the innermost
  ``sdr.*`` span the host was in; outside every ``sdr.call`` it is the
  harness's (``bench.submit``'s holder copies, ``bench.fetch``).
- The trace's device times do not keep to its host clock: on an H100
  under torch 2.11 / CUDA 12.8 they wandered by up to 8 ms against it
  within a 20 s window, jumping back and forth between stretches of a
  few seconds in which they agree. So before the split each request's
  operations are moved together by the least lead of any of them (its
  start less the host start of its launch): the operation that started
  soonest after its launch is taken to start at it, a few microseconds
  early. A request is short beside the stretches; ``launch_leads`` gives
  the raw leads.

``read`` gives None where the trace has no ``sdr.call`` span (a program
without them) or not one for each call, and every reader then reads
nothing. Times are in microseconds, as the trace gives them.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from harness import trace as tr

CALL = "sdr.call"
STAGES = ("sdr.upload", "sdr.prep", "sdr.matcher", "sdr.wls", "sdr.post")
# the layer (BENCHMARK.json's short name) of each span's host time; the
# call's own code outside its stages is the pipeline's, as is the upload
LAYER = {CALL: "pipeline", "sdr.upload": "pipeline", "sdr.prep": "prep",
         "sdr.matcher": "matcher", "sdr.wls": "wls", "sdr.post": "post"}
OUTSIDE = None          # the key of host time outside every sdr.call


def span_layer(span: str) -> str:
    """The span's layer: LAYER's entry, else the name after ``sdr.``
    (``sdr.voxel``'s layer is ``voxel``)."""
    return LAYER.get(span, span[len("sdr."):])


@dataclasses.dataclass
class Spans:
    calls: List[tr.Op]              # the sdr.call spans, in start order
    starts: List[float]             # the innermost span, piecewise:
    ends: List[float]               # [starts[k], ends[k]) is names[k]'s
    names: List[str]
    launch: Dict[int, float]        # correlation id -> host start

    def at(self, t: float) -> Optional[str]:
        """The innermost ``sdr.*`` span open at host time ``t``."""
        k = bisect.bisect_right(self.starts, t) - 1
        return self.names[k] if k >= 0 and t < self.ends[k] else OUTSIDE

    def split(self, lo: float, hi: float, out: Dict) -> None:
        """Adds the length of [lo, hi] under each innermost span to
        ``out``, what no span covers under OUTSIDE."""
        k = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        inside = 0.0
        while k < len(self.starts) and self.starts[k] < hi:
            d = min(self.ends[k], hi) - max(self.starts[k], lo)
            if d > 0:
                out[self.names[k]] += d
                inside += d
            k += 1
        out[OUTSIDE] += (hi - lo) - inside


def _innermost(spans: List[tr.Op]) -> List[Tuple[float, float, str]]:
    """Nested spans -> disjoint pieces (start, end, innermost name)."""
    spans = sorted(spans, key=lambda o: (o.ts, -o.dur))
    points = sorted({t for o in spans for t in (o.ts, o.end)})
    out, stack, k = [], [], 0
    for a, b in zip(points, points[1:]):
        while k < len(spans) and spans[k].ts <= a:
            stack.append(spans[k])
            k += 1
        stack = [o for o in stack if o.end > a]
        if stack:
            out.append((a, b, stack[-1].name))
    return out


def _launches(trace: tr.Trace) -> Dict[int, float]:
    """Correlation id -> host start of the main thread's runtime calls."""
    return {o.corr: o.ts for o in trace.host
            if o.cat in tr.RUNTIME_CATS and o.corr is not None}


def read(trace: Optional[tr.Trace]) -> Optional[Spans]:
    """The trace's ``sdr.*`` spans, or None where it has no ``sdr.call``
    or not one for each call."""
    if trace is None:
        return None
    mine = [o for o in trace.host if o.cat == "user_annotation"
            and o.name.startswith("sdr.")]
    calls = [o for o in mine if o.name == CALL]
    if not calls or len(calls) != len(trace.calls):
        return None
    pieces = _innermost(mine)
    return Spans(calls, [p[0] for p in pieces], [p[1] for p in pieces],
                 [p[2] for p in pieces], _launches(trace))


def ops_by_span(trace: tr.Trace, sp: Spans) -> Dict[Optional[str],
                                                    List[tr.Op]]:
    """Each call's device operations under the innermost span open at
    their launch; OUTSIDE holds those launched outside every span, or by
    no runtime call of the main thread."""
    out: Dict[Optional[str], List[tr.Op]] = defaultdict(list)
    for call in trace.calls:
        for o in call.ops:
            t = sp.launch.get(o.corr)
            out[OUTSIDE if t is None else sp.at(t)].append(o)
    return out


def shift(call: tr.CallTrace, launch: Dict[int, float]) -> float:
    """The call's least lead: the start of one of its device operations
    less the host start of its launch, the least of them."""
    return min((o.ts - launch[o.corr] for o in call.ops if o.corr in launch),
               default=0.0)


def aligned(call: tr.CallTrace, launch: Dict[int, float]) -> List[tr.Op]:
    """The call's device operations moved onto the host clock by its least
    lead, so that the one that started soonest after its launch starts at
    it."""
    d = shift(call, launch)
    return [dataclasses.replace(o, ts=o.ts - d) for o in call.ops]


def request_idle(trace: tr.Trace, sp: Spans) -> Dict[Optional[str], float]:
    """The requests' device idle time (each request's interval less the
    union of its own operations, aligned), split by the innermost span the
    host was in; OUTSIDE is the harness's share."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for call in trace.calls:
        if call.request is None:
            continue
        lo, hi = call.request
        t = lo
        for a, b in tr.merged(aligned(call, sp.launch)):
            if a > t:
                sp.split(t, min(a, hi), out)
            t = max(t, b)
            if t >= hi:
                break
        if t < hi:
            sp.split(t, hi, out)
    return out


def launch_leads(trace: tr.Trace) -> List[float]:
    """For each device operation launched by a runtime call of the main
    thread: its start less that call's host start, as the trace gives
    them. Where the device's times keep to the host clock none is
    negative."""
    launch = _launches(trace)
    return [o.ts - launch[o.corr] for o in trace.device if o.corr in launch]


def device_ms_per_frame(run, span: str) -> Optional[float]:
    """Device ms a frame of the operations launched inside ``span``."""
    sp = read(run.trace)
    frames = sum(c.frames for c in run.trace.calls) if sp else 0
    if not frames:
        return None
    return sum(o.dur for o in ops_by_span(run.trace, sp)[span]) \
        * 1e-3 / frames


def call_ms_per_pair(run) -> Optional[float]:
    """The host's ms in ``sdr.call`` a pair."""
    sp = read(run.trace)
    frames = sum(c.frames for c in run.trace.calls) if sp else 0
    if not frames:
        return None
    return sum(o.dur for o in sp.calls) * 1e-3 / frames


def idle_ms_per_pair(run, layer: str) -> Optional[float]:
    """Device idle ms a pair of the requests while the host's innermost
    span was one of ``layer``'s."""
    sp = read(run.trace)
    pairs = sum(c.frames for c in run.trace.calls
                if c.request is not None) if sp else 0
    if not pairs:
        return None
    idle = request_idle(run.trace, sp)
    return sum(v for k, v in idle.items()
               if k is not OUTSIDE and span_layer(k) == layer) * 1e-3 / pairs
