"""The port's stage profiler: utils/profiling.py (StageSpec, stage_time,
roofline_report, the counterpart of the JAX package's utils/profiling.py)
on CPU stages, and tools/profile_stages_torch.py run small on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import torch

from stereo_depth_ruler_tpu_torch.utils import profiling as tp

ROOT = Path(__file__).resolve().parent.parent


def test_roofline_report_keys_and_bounds(tmp_path):
    x = torch.ones(1000)
    calls = []
    stages = [
        # 3.35e9 bytes take 1 ms at the memory rate, 67e8 operations 0.1 ms
        tp.StageSpec("copy", lambda: calls.append(1) or x.clone(),
                     bytes_accessed=3.35e9, flops=67e8),
        # 67e9 operations take 1 ms at the float32 rate
        tp.StageSpec("math", lambda: x * 2.0, bytes_accessed=3.35e8,
                     flops=67e9),
    ]
    out = tmp_path / "report.json"
    rep = tp.roofline_report(stages, reps=3, device="cpu", out_path=str(out))
    assert len(calls) == 4                      # one warm-up and three reps
    rows = {r["stage"]: r for r in rep["stages"]}
    for r in rows.values():
        assert set(r) == {"stage", "ms", "bound_ms", "bound", "sol_frac",
                          "gbps_achieved"}
        assert r["ms"] > 0
        assert r["sol_frac"] == pytest.approx(r["bound_ms"] / r["ms"])
    assert rows["copy"]["bound"] == "bandwidth"
    assert rows["copy"]["bound_ms"] == pytest.approx(1.0)
    assert rows["copy"]["gbps_achieved"] == pytest.approx(
        3.35e9 / (rows["copy"]["ms"] / 1e3) / 1e9)
    assert rows["math"]["bound"] == "compute"
    assert rows["math"]["bound_ms"] == pytest.approx(1.0)
    assert rep["total_ms"] == pytest.approx(sum(r["ms"] for r in
                                                rep["stages"]))
    assert (rep["hbm_bytes_per_s"], rep["fp32_ops_per_s"]) == (3.35e12,
                                                               67e12)
    assert json.loads(out.read_text())["stages"] == rep["stages"]


def test_stage_time_cpu_counts_calls():
    n = []
    ms = tp.stage_time(lambda: n.append(1), reps=4, device="cpu")
    assert len(n) == 5 and ms >= 0


def test_profile_stages_tool_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "tools/profile_stages_torch.py", "--device", "cpu",
         "--size", "16x40x16", "--reps", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for stage in ("K1 cost_volume", "cost_down", "wta_lr3",
                  "K2 pass (-1,+1) int16 S +acc",
                  "transpose (W,D,H)->(H,D,W) [kernel]",
                  "sgbm_staged_cuda whole", "sum of stages, fused chain",
                  "sum of stages, staged chain"):
        assert stage in out.stderr, stage
