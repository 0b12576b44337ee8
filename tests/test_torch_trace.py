"""The pipeline's profiler spans: one ``sdr.call`` per call holding the
stage spans in order and apart, and no span at all while no profiler
records. On the CPU at 24x32, through the plain versions of the kernels."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch import pipeline as tp

SLICE = SGBMParams(num_disparities=16, speckle_window_size=0)
STAGES = ["sdr.upload", "sdr.prep", "sdr.matcher", "sdr.wls", "sdr.post"]
CONFIGS = {"stacked_wls": dict(),
           "shared_wls": dict(pair_mode="shared"),
           "no_wls": dict(use_wls=False)}


def _pipeline(**cfg):
    rig = StereoRig.synthetic(width=32, height=24)
    return tp.StereoPipeline(rig, tp.PipelineConfig(sgbm=SLICE, downscale=1,
                                                    **cfg), device="cpu")


def _frames(n=1):
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (n, 24, 32)).astype(np.uint8)
    return left, np.roll(left, -3, axis=2)


def _sdr_spans(prof, tmp_path):
    """The exported trace's ``sdr.*`` spans as (start, end, name), in
    start order, outer before inner at one start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("sdr.")]
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def _check_calls(spans, n_calls, stages):
    """n_calls ``sdr.call`` spans, each holding exactly ``stages`` in order
    and apart, and no ``sdr.*`` span outside a call."""
    calls = [s for s in spans if s[2] == "sdr.call"]
    assert len(calls) == n_calls
    inside = 0
    for a, b, _ in calls:
        mine = [s for s in spans if s[2] != "sdr.call"
                and a <= s[0] and s[1] <= b]
        assert [s[2] for s in mine] == stages
        for (_, end, _), (start, _, _) in zip(mine, mine[1:]):
            assert end <= start
        inside += len(mine)
    assert inside + len(calls) == len(spans)


@pytest.mark.parametrize("entry", ["process_pair", "process_batch"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_call_holds_its_stage_spans_in_order(tmp_path, name, entry):
    pipe = _pipeline(**CONFIGS[name])
    left, right = _frames(2)
    if entry == "process_pair":
        left, right = left[0], right[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            getattr(pipe, entry)(left, right)
    stages = [s for s in STAGES if name != "no_wls" or s != "sdr.wls"]
    _check_calls(_sdr_spans(prof, tmp_path), 2, stages)


def test_process_sbs_makes_one_call_span(tmp_path):
    pipe = _pipeline()
    left, right = _frames()
    frame = np.concatenate([left[0], right[0]], axis=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.process_sbs(frame)
    _check_calls(_sdr_spans(prof, tmp_path), 1, STAGES)


def test_no_span_is_made_while_no_profiler_records(monkeypatch):
    """With no profiler recording the pipeline calls no record_function,
    and its outputs equal a profiled run's bit for bit."""
    pipe = _pipeline()
    left, right = _frames(2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = pipe.process_batch(left, right)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(tp, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    plain = pipe.process_batch(left, right)
    pair = pipe.process_pair(left[0], right[0])
    assert traced.keys() == plain.keys() == pair.keys()
    for k in traced:
        # bit for bit; a frame with no valid depth has a NaN mean depth
        torch.testing.assert_close(plain[k], traced[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
        torch.testing.assert_close(pair[k], traced[k][0], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


@pytest.mark.cuda
def test_a_replayed_call_holds_the_upload_and_one_graph_launch(tmp_path):
    """On the card the third call with one signature replays the captured
    graph: its ``sdr.call`` holds ``sdr.upload`` and no stage span, and the
    runtime launched the graph once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = SGBMParams(num_disparities=32, speckle_window_size=20)
    pipe = tp.StereoPipeline(StereoRig.synthetic(width=160, height=96),
                             tp.PipelineConfig(sgbm=params, downscale=1),
                             device="cuda")
    rng = np.random.default_rng(5)
    left = rng.integers(0, 256, (96, 160), dtype=np.uint8)
    right = np.roll(left, -5, axis=1)
    for _ in range(2):                  # eager, then the capture
        pipe.process_pair(left, right)
    before = dict(tp.GRAPH_CALLS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.process_pair(left, right)
        torch.cuda.synchronize()
    assert tp.GRAPH_CALLS["replayed"] == before["replayed"] + 1
    _check_calls(_sdr_spans(prof, tmp_path), 1, ["sdr.upload"])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "cuda_runtime"
                and e["name"].startswith("cudaGraphLaunch")]
    assert len(launches) == 1, [e["name"] for e in events
                                if e.get("cat") == "cuda_runtime"]
