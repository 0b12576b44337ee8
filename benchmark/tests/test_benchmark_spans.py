"""The readers of the program's stage spans (harness/spans.py) on
synthetic traces, a tiny traced run on the CPU, and on the card a traced
run whose operations fall under the spans that launched them."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from harness import cell, spans, trace as tr

BENCH = Path(__file__).resolve().parent.parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
SPAN_METRICS = sorted(m["name"] for m in SPEC["per_layer"]
                      if m["source"] == "program_span")


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one request, relative to its start: the program's spans inside
# bench.submit, and each device operation as (host launch, device start,
# length, name); the fourth starts at its launch
SPANS = [("sdr.call", 20, 460), ("sdr.upload", 30, 30), ("sdr.prep", 70, 80),
         ("sdr.matcher", 160, 140), ("sdr.wls", 310, 90),
         ("sdr.post", 410, 60)]
OPS = [(35, 40, 10, "Memcpy HtoD (Pageable -> Device)"),
       (80, 90, 30, "void at::native::index_elementwise_kernel<1>()"),
       (170, 180, 220, "void tile_sweep_kernel<2, true, true>(short*)"),
       (305, 305, 10, "void at::native::elementwise_kernel<2>()"),
       (320, 400, 50, "fgs_pass_kernel(float const*)"),
       (420, 450, 10, "void at::native::elementwise_kernel<4>()"),
       (610, 612, 3, "Memcpy DtoH (Device -> Pageable)")]


def live_trace(requests=2, drop=(), spans_=SPANS):
    """``requests`` open-loop requests of 1000 us, 2000 us apart, each with
    ``spans_`` and OPS; spans named in ``drop`` are left out."""
    ev = [_ev("bench.window", "user_annotation", 0, 2000 * requests)]
    corr = 0
    for i in range(requests):
        base = 2000 * i
        ev.append(_ev("bench.request", "user_annotation", base, 1000))
        ev.append(_ev("bench.submit", "user_annotation", base + 10, 490))
        ev.append(_ev("bench.fetch", "user_annotation", base + 600, 390))
        ev += [_ev(n, "user_annotation", base + a, d) for n, a, d in spans_
               if n not in drop]
        for host, dev, dur, name in OPS:
            corr += 1
            ev.append(_ev("cudaLaunchKernel", "cuda_runtime", base + host, 1,
                          corr=corr))
            ev.append(_ev(name, "gpu_memcpy" if "Memcpy" in name
                          else "kernel", base + dev, dur, tid=7, corr=corr))
    return tr.build(ev, [1] * requests)


def _measured(t):
    return cell.Measured({}, {}, 1.0, 0.0, [], 0.0, 0, trace=t)


def test_operations_go_to_the_innermost_span_at_their_launch():
    t = live_trace()
    sp = spans.read(t)
    by = {k: [o.dur for o in v] for k, v in spans.ops_by_span(t, sp).items()}
    assert by == {"sdr.upload": [10.0] * 2, "sdr.prep": [30.0] * 2,
                  "sdr.matcher": [220.0] * 2, "sdr.call": [10.0] * 2,
                  "sdr.wls": [50.0] * 2, "sdr.post": [10.0] * 2,
                  spans.OUTSIDE: [3.0] * 2}
    # the matcher's kernel runs on past its span: still the matcher's
    assert sp.at(2000 + 170) == "sdr.matcher"
    assert sp.at(2000 + 305) == "sdr.call"
    assert sp.at(2000 + 5) is spans.OUTSIDE
    m = _measured(t)
    assert cell.reader("prep_span_ms_per_frame.batch")(m) == pytest.approx(
        0.030)
    assert cell.reader("post_span_ms_per_frame.batch")(m) == pytest.approx(
        0.010)
    assert cell.reader("call_host_ms_per_pair.live")(m) == pytest.approx(
        0.460)


def test_idle_readings_add_up_to_the_requests_idle_time():
    """Busy 40-50, 90-120, 180-460, 612-615 of each 1000 us request; the
    idle 677 us split by the host's innermost span at each instant."""
    t = live_trace()
    m = _measured(t)
    got = {layer: cell.reader(f"{layer}_idle_ms_per_pair.live")(m)
           for layer in ("pipeline", "prep", "matcher", "wls", "post")}
    assert got == pytest.approx({"pipeline": 0.060, "prep": 0.050,
                                 "matcher": 0.020, "wls": 0.0,
                                 "post": 0.010})
    idle = spans.request_idle(t, spans.read(t))
    assert idle[spans.OUTSIDE] == pytest.approx(2 * 537.0)
    pct = cell.reader("device_idle_pct.live")(m)
    request_idle_ms = pct / 100 * 2 * 1.0          # two 1 ms requests
    inside_ms = sum(got.values()) * 2
    assert inside_ms + idle[spans.OUTSIDE] * 1e-3 == pytest.approx(
        request_idle_ms)


def test_a_span_without_a_table_entry_is_its_own_layer():
    """A program's ``sdr.voxel`` span, which LAYER does not name, cut from
    the end of ``sdr.post``: its idle reads under ``voxel``, post's drops
    by as much, and the pipeline's other layers read as before."""
    voxel = [s for s in SPANS if s[0] != "sdr.post"] + [
        ("sdr.post", 410, 40), ("sdr.voxel", 450, 20)]
    m, before = _measured(live_trace(spans_=voxel)), _measured(live_trace())
    assert spans.span_layer("sdr.voxel") == "voxel"
    assert spans.idle_ms_per_pair(m, "voxel") == pytest.approx(0.010)
    assert spans.idle_ms_per_pair(m, "post") == pytest.approx(0.0)
    for layer in ("pipeline", "prep", "matcher", "wls"):
        assert spans.idle_ms_per_pair(m, layer) == pytest.approx(
            spans.idle_ms_per_pair(before, layer)), layer
    assert spans.idle_ms_per_pair(before, "voxel") == 0.0


@pytest.mark.parametrize("drop", [("sdr.call",), tuple(n for n, *_ in SPANS)],
                         ids=["no_call_span", "no_span"])
def test_readers_read_nothing_without_a_call_span_each(drop):
    """A program without the spans (or a count of sdr.call spans that is
    not the calls') reads None, where the kernel-order readers read."""
    m = _measured(live_trace(drop=drop))
    for name in SPAN_METRICS:
        assert cell.reader(name)(m) is None, name
    assert cell.reader("device_idle_pct.live")(m) is not None


def test_readers_read_nothing_on_a_call_count_mismatch():
    t = live_trace(3)
    t.calls = t.calls[:2]
    m = _measured(t)
    for name in SPAN_METRICS:
        assert cell.reader(name)(m) is None, name


def test_launch_leads_show_a_device_clock_behind_the_host():
    t = live_trace(1)
    assert min(spans.launch_leads(t)) == 0.0
    t.device[0].ts -= 6.0          # the upload now starts before its launch
    assert min(spans.launch_leads(t)) == pytest.approx(-1.0)


@pytest.mark.parametrize("skew", [-3000.0, -0.5, 250.0])
def test_idle_split_keeps_to_each_requests_own_clock(skew):
    """Device times off the host clock, by another amount in each request:
    each request is aligned by its own least lead, and the split is the
    one of the unskewed trace."""
    want = live_trace()
    t = live_trace()
    for i, call in enumerate(t.calls):
        for o in call.ops:
            o.ts += skew * (i + 1)
    assert min(spans.launch_leads(t)) < 0 or skew > 0
    for layer in ("pipeline", "prep", "matcher", "wls", "post"):
        name = f"{layer}_idle_ms_per_pair.live"
        assert cell.reader(name)(_measured(t)) == pytest.approx(
            cell.reader(name)(_measured(want))), layer
    assert spans.request_idle(t, spans.read(t)) == pytest.approx(
        spans.request_idle(want, spans.read(want)))


def test_a_tiny_traced_run_reads_the_spans(tiny_cell):
    """On the CPU the trace holds no device operation, but one sdr.call
    per call: every span reader reads. The closed loop's window is long
    enough to reach both of its slots under the profiler; the open loop
    runs every request due in its window, however long they take."""
    for name, seconds in (("hd720_d128_full.batch8", 1.0),
                          ("hd720_d128_full.live30", 0.3)):
        c = tiny_cell(name)
        r = cell.run(c, 2 ** 31 + 7, seconds, True, "cpu",
                     time.perf_counter(), lambda m: None)
        want = {m["name"] for m in c.per_layer} & set(SPAN_METRICS)
        assert want and want <= set(r["metrics"]), r["metrics"]


def _traced(c, monkeypatch):
    """A traced run of the cell on the card, with the Trace it read."""
    kept = []
    build = tr.build

    def keep(*args):
        kept.append(build(*args))
        return kept[-1]

    monkeypatch.setattr(tr, "build", keep)
    r = cell.run(c, 2 ** 31 + 11, 0.5, True, "cuda:0", time.perf_counter(),
                 lambda m: None)
    return r, kept[0]


def _graph_launches(t, call_span):
    """The ``cudaGraphLaunch`` runtime calls inside one ``sdr.call``."""
    return [o for o in t.host if o.cat in tr.RUNTIME_CATS
            and o.name.startswith("cudaGraphLaunch")
            and call_span.ts <= o.ts and o.end <= call_span.end]


def _inner_spans(t, call_span):
    """The names of the ``sdr.*`` spans inside one ``sdr.call``."""
    return [o.name for o in t.host if o.cat == "user_annotation"
            and o.name.startswith("sdr.") and o.name != spans.CALL
            and call_span.ts <= o.ts and o.end <= call_span.end]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hd720_d128_full.batch8",
                                  "hd720_d128_full.live30"])
def test_spans_and_launches_share_the_host_clock_on_the_card(
        tiny_cell, monkeypatch, name):
    """Every span metric of the cell reads; the device operations fall
    under the program's spans that launched them (host clock against host
    clock). An eager call's stages each launch some. A replayed call (a
    ``cudaGraphLaunch`` inside its ``sdr.call``, process_pair's captured
    graph) holds only ``sdr.upload`` and one graph launch, and no stage
    after the upload launches anything. Aligned, every operation of a
    request lies inside it. The device's raw leads, which need not keep to
    the host clock, are in the message."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = tiny_cell(name, w=256, h=128, D=32)
    r, t = _traced(c, monkeypatch)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in c.per_layer} & set(SPAN_METRICS)
    assert want <= set(r["metrics"]), r["metrics"]
    sp = spans.read(t)
    counts = {k: len(v) for k, v in spans.ops_by_span(t, sp).items()}
    leads = spans.launch_leads(t)
    msg = (counts, min(leads), sum(d < 0 for d in leads), len(leads))
    assert len(leads) == len(t.device), msg
    replayed = [bool(_graph_launches(t, s)) for s in sp.calls]
    eager = [call for call, g in zip(t.calls, replayed) if not g]
    eager_counts = {k: len(v) for k, v in spans.ops_by_span(
        dataclasses.replace(t, calls=eager), sp).items()}
    assert all(eager_counts.get(s, 0) >= len(eager)
               for s in spans.STAGES), (eager_counts, msg)
    for s, g in zip(sp.calls, replayed):
        if g:
            assert _inner_spans(t, s) == ["sdr.upload"], msg
            assert len(_graph_launches(t, s)) == 1, msg
    graphed = [call for call, g in zip(t.calls, replayed) if g]
    graph_counts = {k: len(v) for k, v in spans.ops_by_span(
        dataclasses.replace(t, calls=graphed), sp).items()}
    assert not any(graph_counts.get(s) for s in spans.STAGES[1:]), (
        graph_counts, msg)
    assert counts.get(spans.OUTSIDE, 0) <= 0.05 * sum(counts.values()), msg
    for call in t.calls:
        if call.request is not None:
            lo, hi = call.request
            ops = spans.aligned(call, sp.launch)
            assert lo <= min(o.ts for o in ops), msg
            assert max(o.end for o in ops) <= hi + 1.0, msg
