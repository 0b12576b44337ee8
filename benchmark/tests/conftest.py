"""Shared helpers of the benchmark's own tests: the benchmark's folders on
sys.path and cells cut to a size the CPU runs in seconds."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(name: str, w: int = 96, h: int = 64, D: int = 16):
    """The cell ``name`` (<config>.<traffic>, a BENCHMARK.json cell or a
    pairing of the files under configs/ and traffic/) at w x h with D
    disparities, a pool of 4 pairs, batches of at most 2, 2 checked pairs;
    the rig scaled with the width."""
    import json
    from harness import cell
    try:
        c = cell.load(name)
    except KeyError:
        # not a cell of BENCHMARK.json: the files paired, reporting the
        # metrics of a cell that has the same traffic
        config, trf = name.split(".")
        spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
        like = cell.load(next(w["name"] for w in spec["workloads"]
                              if w["traffic"] == trf))
        c = cell.Cell(name, 1, json.loads(
            (BENCH / "configs" / f"{config}.json").read_text()),
            like.traffic, like.end_to_end, like.per_layer)
    cfg = copy.deepcopy(c.config)
    s = w / cfg["rig"]["width"]
    for k in ("fx", "fy", "cx", "cy", "rect_focal", "rect_cx", "rect_cy"):
        cfg["rig"][k] *= s
    cfg["rig"].update(width=w, height=h)
    cfg["sgbm"].update(num_disparities=D, speckle_window_size=20)
    cfg["check_pairs"] = 2
    c.config = cfg
    c.traffic = dict(c.traffic, pool=4, distinct=2,
                     batch=min(2, c.traffic["batch"]))
    return c


@pytest.fixture
def tiny_cell():
    return tiny
