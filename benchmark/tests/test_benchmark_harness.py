"""CPU tests of the yardstick: the traffic generator and the end-to-end
arithmetic, the roofline tallies, the trace reduction, the files found by
name, and the reference against the program's plain CPU path. Card-only
cases are marked ``cuda`` and skip inside the test."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import cell, inputs, trace as tr, traffic
from roofline import peaks, sgbm as r_sgbm, wls as r_wls
import reference

BENCH = Path(__file__).resolve().parent.parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


class FakeClock:
    """A host clock that only moves when the code under test sleeps or
    when a fake call takes time."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def wait(self, due):
        self.t = max(self.t, due)


def test_open_loop_times_from_the_due_time_and_reports_lateness():
    clk = FakeClock()
    cost = {3: 0.100}            # call 3 stalls for 100 ms

    def submit(call):
        clk.t += cost.get(call.index, 0.005)
        return call.index

    trf = {"mode": "open", "batch": 1, "rate_hz": 10.0}
    t0, calls = traffic.run(trf, 1.0, submit, lambda h: np.zeros((1, 3)),
                            np.arange(4), clock=clk, wait=clk.wait)
    assert len(calls) == 10                       # every due time in 1 s
    assert [c.due - t0 for c in calls] == pytest.approx(
        [i / 10 for i in range(10)])
    assert calls[3].latency == pytest.approx(0.100)
    # call 4 was due at 0.4 s, started at 0.4 s: the stall had ended
    assert calls[4].lateness == pytest.approx(0.0)
    cost[5] = 0.250
    t0, calls = traffic.run(trf, 1.0, submit, lambda h: np.zeros((1, 3)),
                            np.arange(4), clock=clk, wait=clk.wait)
    # call 6 was due 0.1 s after call 5, which took 0.25 s: 0.15 s late,
    # and its latency counts that wait
    assert calls[6].lateness == pytest.approx(0.15)
    assert calls[6].latency == pytest.approx(0.155)


def test_the_generator_sleeps_only_to_its_spin_margin_then_spins():
    clk = FakeClock()
    slept = []

    def sleep(s):             # an oversleep shorter than the margin
        slept.append(s)
        clk.t += s + 0.006

    def clock():
        clk.t += 1e-4         # each reading takes a little time
        return clk.t

    traffic.sleep_until(100.050, clock=clock, sleep=sleep)
    assert slept == [pytest.approx(0.050 - traffic.SPIN_S, abs=2e-4)]
    assert 100.050 <= clk.t < 100.051          # on time despite the wake
    slept.clear()
    traffic.sleep_until(clk.t + traffic.SPIN_S / 2, clock=clock, sleep=sleep)
    assert slept == []                         # inside the margin: spins


def test_closed_loop_keeps_one_call_ahead_and_counts_the_whole_window():
    clk = FakeClock()
    log = []

    def submit(call):
        log.append(("submit", call.index))
        clk.t += 0.030
        return call.index

    def fetch(h):
        log.append(("fetch", h))
        return np.zeros((8, 3))

    trf = {"mode": "closed", "batch": 8, "ahead": 1}
    t0, calls = traffic.run(trf, 1.0, submit, fetch, np.arange(16),
                            clock=clk)
    assert log[:4] == [("submit", 0), ("submit", 1), ("fetch", 0),
                       ("submit", 2)]
    assert all(c.stats is not None for c in calls)
    assert [c.slot for c in calls[:3]] == [0, 1, 0]
    # 34 calls submitted within the second (each 30 ms, the last from
    # 0.99 s to 1.02 s); call 32's stats come only after call 33's submit,
    # so 32 calls are done inside it: the rate is their frames over the
    # window's length
    assert len(calls) == 34
    assert sum(1 for c in calls if c.done - t0 <= 1.0) == 32
    assert traffic.frames_per_s(t0, 1.0, calls) == 8 * 32


def test_percentiles_are_over_every_request():
    calls = [traffic.Call(i, 0, np.array([0]), 0.0, 0.0, done=lat)
             for i, lat in enumerate([0.001] * 90 + [0.050] * 10)]
    want = np.percentile([c.latency for c in calls], 95) * 1e3
    assert traffic.percentile_ms(calls, 95) == pytest.approx(want)
    # medians of ten chunks of ten would read 1 ms; the tail is 50 ms
    assert traffic.percentile_ms(calls, 95) > 25.0
    assert traffic.percentile_ms(calls, 50) == pytest.approx(1.0)


def test_order_gives_every_pair_equally_and_depends_on_the_seed():
    a = traffic.order(16, 64, 2 ** 31 + 11)
    assert sorted(np.bincount(a)) == [4] * 16
    assert not np.array_equal(a, traffic.order(16, 64, 2 ** 31 + 12))
    assert np.array_equal(a, traffic.order(16, 64, 2 ** 31 + 11))


def test_roofline_counts_equal_a_hand_tally():
    # 2 frames of 3 x 4 pixels at 5 disparities, 8 paths: per voxel 10 +
    # 4 + 8 * 8 + 3 = 81, per pixel 60
    assert r_sgbm.ops(2, 3, 4, 5, 8, 5) == 2 * 12 * (5 * 81 + 60)
    assert r_sgbm.ops(1, 3, 4, 5, 4, 7) == 12 * (5 * (17 + 32) + 60)
    assert r_sgbm.nbytes(2, 3, 4) == 2 * 12 * 12
    # per pixel 11 + 3 + 23 * 2 * 3 = 152
    assert r_wls.ops(2, 3, 4, 3) == 2 * 12 * 152
    assert r_wls.nbytes(2, 3, 4) == 2 * 12 * 20
    # the larger bound over the time: 67e12 ops in 2 s is half the peak
    assert peaks.share_pct(67e12, 1.0, 2.0) == pytest.approx(50.0)
    assert peaks.share_pct(1.0, 3.35e12, 4.0) == pytest.approx(25.0)
    assert peaks.share_pct(1.0, 1.0, 0.0) is None


def test_kernel_names_sort_into_layers():
    names = {
        "void (anonymous namespace)::cost_box_kernel<5>(float const*)": "m",
        "void tile_sweep_kernel<2, true, true>(short const*, short*)": "m",
        "tile_horiz_kernel<8>(short const*, short*, int)": "m",
        "labels_tiles(float const*, int*, int, int, int, float, bool)": "m",
        "keep_apply(float const*, int const*, float*, int)": "m",
        "fgs_pass_kernel(float const*, float const*, float*)": "w",
        "shift_gather_conf_kernel(float const*, float const*)": "w",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>>(int, float)": "",
        "void at::native::index_elementwise_kernel<128, 4>(long)": "",
    }
    for name, layer in names.items():
        got = ("m" if r_sgbm.KERNELS.search(name) else
               "w" if r_wls.KERNELS.search(name) else "")
        assert got == layer, name
    assert tr._short("void (anonymous namespace)::cost_box_kernel<5>"
                     "(float const*)") == "cost_box_kernel<5>"
    assert tr._short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Two calls of 2 frames each: per call an upload, a gather (prep),
    the matcher's kernel, a WLS kernel, a reprojection kernel (post) and
    the stats copy issued by the fetch."""
    ev = [_ev("bench.window", "user_annotation", 0, 1000)]
    corr = 0
    for c, base in enumerate((0, 500)):
        ev.append(_ev("bench.submit", "user_annotation", base + 1, 50))
        ev.append(_ev("bench.fetch", "user_annotation", base + 60, 300))
        dev = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 10),
               ("void at::native::index_elementwise_kernel<1>()", "kernel",
                20),
               ("void tile_sweep_kernel<2, true, true>(short*)", "kernel",
                100),
               ("fgs_pass_kernel(float const*)", "kernel", 30),
               ("void at::native::elementwise_kernel<2>()", "kernel", 5),
               ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 2)]
        t = base + 100
        for k, (name, cat, dur) in enumerate(dev):
            corr += 1
            host_t = base + 2 + k if k < 5 else base + 61
            ev.append(_ev("cudaLaunchKernel", "cuda_runtime", host_t, 1,
                          corr=corr))
            ev.append(_ev(name, cat, t, dur, tid=7, corr=corr))
            t += dur
    return ev


def test_trace_reduction_attributes_operations_to_calls_and_stages():
    t = tr.build(synthetic_trace(), [2, 2])
    assert [len(c.ops) for c in t.calls] == [6, 6]
    s = tr.stage_sums(t, r_sgbm.KERNELS, r_wls.KERNELS)
    assert s == {"upload": 20.0, "prep": 40.0, "matcher": 200.0,
                 "wls": 60.0, "post": 10.0, "other": 4.0, "frames": 4}
    # busy 167 us a call of the 1000 us window
    assert tr.busy_us(t) == pytest.approx(334.0)
    m = cell.Measured({}, {}, 1.0, 0.0, [], 0.0, 0, trace=t)
    assert cell.reader("device_idle_pct.batch")(m) == pytest.approx(66.6)
    assert cell.reader("upload_ms_per_frame.batch")(m) == pytest.approx(
        0.005)
    assert cell.reader("post_ms_per_frame.batch")(m) == pytest.approx(
        0.0025)
    bd = tr.breakdown(t)
    assert bd["device_ops"][0] == ["tile_sweep_kernel<2, true, true>",
                                   pytest.approx(200e-6)]
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(666e-6)


def test_idle_inside_requests_reads_each_requests_own_operations():
    """Two requests of 1000 us, each with 400 us of device work; the device
    clock runs 300 us behind the host's, which must not change the share."""
    ev = [_ev("bench.window", "user_annotation", 0, 5000)]
    for i, base in enumerate((0, 2000)):
        ev.append(_ev("bench.request", "user_annotation", base, 1000))
        ev.append(_ev("bench.submit", "user_annotation", base + 1, 500))
        ev.append(_ev("bench.fetch", "user_annotation", base + 600, 390))
        for k, (t, dur) in enumerate(((100, 250), (400, 150))):
            corr = 10 * i + k
            ev.append(_ev("cudaLaunchKernel", "cuda_runtime", base + 2 + k, 1,
                          corr=corr))
            ev.append(_ev("fgs_pass_kernel(float)", "kernel",
                          base + t + 300, dur, tid=7, corr=corr))
    t = tr.build(ev, [1, 1])
    m = cell.Measured({}, {}, 1.0, 0.0, [], 0.0, 0, trace=t)
    assert cell.reader("device_idle_pct.live")(m) == pytest.approx(60.0)
    assert cell.reader("launches_per_pair.live")(m) == 2.0


def test_readers_return_nothing_without_a_trace():
    m = cell.Measured({}, {}, 1.0, 0.0, [], 0.0, 0)
    for entry in SPEC["per_layer"]:
        assert cell.reader(entry["name"])(m) is None, entry["name"]


def test_every_cell_and_metric_is_found_by_name():
    for w in SPEC["workloads"]:
        c = cell.load(w["name"])
        assert c.config["name"] == w["config"]
        assert c.traffic["mode"] in ("open", "closed")
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, w["name"]
        for m in c.end_to_end + c.per_layer:
            assert callable(cell.reader(m["name"]))
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
        moved = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(moved["workloads"])
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for path in sorted((BENCH / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        drv = cell.driver(cfg.get("driver", "pipeline"))
        assert set(cfg["limits"]) == set(drv.NAMES), path.name


def test_benchmark_json_entries_have_exactly_their_keys():
    import re
    name_re = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
    text_ok = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        assert text_ok(c["why"]) and text_ok(c["source"])
        assert all(name_re.fullmatch(k) for k in c["reduced"] + [c["name"]])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
        assert text_ok(w["why"]) and w["chips"] in (1, 4)
        assert all(name_re.fullmatch(w[k])
                   for k in ("name", "config", "traffic"))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}, m
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}, m
        assert text_ok(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert name_re.fullmatch(m["name"]) and m["better"] in ("lower",
                                                                 "higher")
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])


def test_inputs_are_made_from_the_seed(tiny_cell):
    c = tiny_cell("ref_hd720_half_d80.batch8")
    rig_m = inputs.rig(c.config["rig"])
    a = inputs.pool(rig_m, c.config, 2, 2 ** 31 + 3, "cpu")
    b = inputs.pool(rig_m, c.config, 2, 2 ** 31 + 3, "cpu")
    d = inputs.pool(rig_m, c.config, 2, 2 ** 31 + 4, "cpu")
    assert a[0].dtype == np.uint8 and a[0].shape == (2, 64, 96, 3)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], d[0])
    # BGR planes differ
    assert not np.array_equal(a[0][..., 0], a[0][..., 1])


@pytest.mark.parametrize("name", ["hd720_d128_full.batch8",
                                  "ref_hd720_half_d80.live30"])
def test_reference_equals_the_programs_plain_path(tiny_cell, name):
    """The program on the CPU runs its kernels' plain versions; the frozen
    reference gives the same outputs from the same host frames."""
    c = tiny_cell(name)
    rig_m = inputs.rig(c.config["rig"])
    lefts, rights = inputs.pool(rig_m, c.config, 2, 7, "cpu")
    pipe = cell.driver("pipeline").build(c.config, rig_m, "cpu")
    got = pipe.process_batch(lefts, rights)
    want = reference.run(lefts, rights, rig_m, c.config, "cpu", block=1)
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k].float(), v), k


def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny_cell):
    c = tiny_cell("hd720_d128_full.batch8")
    r = cell.run(c, 2 ** 31 + 99, 0.5, False, "cpu", time.perf_counter(),
                 lambda m: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "frames_per_s"}
    assert list(r)[-1] == "checks"
    assert all(v["value"] == 0.0 for v in r["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", ["hd720_d128_full.batch8",
                                  "hd720_d128_full.live30",
                                  "ref_hd720_half_d80.live30"])
def test_a_small_run_on_the_card(tiny_cell, name, trace_on):
    """A whole run on the card's kernels at a small size: correct, and
    every metric of the cell read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = tiny_cell(name, w=256, h=128, D=32)
    r = cell.run(c, 2 ** 31 + 5, 0.5, trace_on, "cuda:0",
                 time.perf_counter(), lambda m: None)
    assert r["correct"], r["checks"]
    specs = c.per_layer if trace_on else c.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in specs}, r["metrics"]
