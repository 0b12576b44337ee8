"""Per-stage timing and a roofline report against the H100's peaks.

Counterpart of ``stereo_depth_ruler_tpu/utils/profiling.py``. A stage is a
function with no arguments that launches its work on tensors it holds;
``stage_time`` times it with CUDA events around ``reps`` calls after a
warm-up (PyTorch returns before the device finishes, so a host clock alone
would time the enqueue), or with ``perf_counter`` when the stage's tensors
lie on the CPU. ``roofline_report`` sets each stage's time beside the least
time the card could take: the larger of its bytes over the memory rate and
its operations over the float32 rate.

The JAX module times a stage inside a chained loop and subtracts an
identity stage's time, a tax of that harness; events time the stage alone,
so the subtraction is dropped, and a row has no ``ms_raw`` or
``harness_ms``.

Peaks (NVIDIA's data sheet, H100 SXM at its full 700 W limit): 3.35 TB/s
of device memory, 67 TFLOP/s in float32 outside the tensor cores. A CPU
run's times are the CPU's; its bounds are still the card's, so only the
bound columns of such a report mean anything.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "StageSpec", "stage_time",
           "roofline_report"]

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def stage_time(fn: Callable[[], object], reps: int = 5,
               device: str = "cuda") -> float:
    """ms per call of ``fn()`` over ``reps`` calls after one warm-up call:
    CUDA events on the current stream for ``device`` "cuda", the host clock
    for "cpu"."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass
class StageSpec:
    name: str
    fn: Callable[[], object]   # launches the stage on tensors it holds
    bytes_accessed: float      # each input read once, each output written once
    flops: float = 0.0         # elementwise operations per call


def roofline_report(stages: List[StageSpec], reps: int = 5,
                    device: str = "cuda",
                    out_path: Optional[str] = None) -> Dict:
    """Time each stage and set it beside its bound. A row holds ``stage``,
    ``ms``, ``bound_ms``, ``bound`` ("bandwidth" or "compute"),
    ``sol_frac`` (bound over time) and ``gbps_achieved``."""
    rows = []
    for s in stages:
        ms = stage_time(s.fn, reps, device)
        bw_bound_ms = s.bytes_accessed / HBM_BYTES_PER_S * 1e3
        cp_bound_ms = s.flops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bw_bound_ms, cp_bound_ms)
        rows.append({
            "stage": s.name,
            "ms": ms,
            "bound_ms": bound_ms,
            "bound": "bandwidth" if bw_bound_ms >= cp_bound_ms else "compute",
            "sol_frac": bound_ms / ms if ms > 0 else None,
            "gbps_achieved": s.bytes_accessed / (ms / 1e3) / 1e9
            if ms > 0 else None,
        })
    report = {"device": device, "hbm_bytes_per_s": HBM_BYTES_PER_S,
              "fp32_ops_per_s": FP32_OPS_PER_S, "stages": rows,
              "total_ms": sum(r["ms"] for r in rows)}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    return report
