"""The comparison that decides ``correct`` must fail what it is there to
catch: its control (the reference computed in bfloat16 in the program's
place) and a run whose timed path is broken underneath, once for each
fault the cells can have. Tiny cells on the CPU; on the card the control
is read at the cells' own size by tools/readings.py."""

import re
import time

import numpy as np
import pytest
import torch

from harness import cell, check, inputs
import reference

CELLS = ["hd720_d128_full.batch8", "ref_hd720_half_d80.live30"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_cell, name):
    c = tiny_cell(name)
    rig_m = inputs.rig(c.config["rig"])
    lefts, rights = inputs.pool(rig_m, c.config, 2, 2 ** 31 + 21, "cpu")
    want = reference.run(lefts, rights, rig_m, c.config, "cpu")
    got = reference.run(lefts, rights, rig_m, c.config, "cpu",
                        dt=torch.bfloat16)
    ref = {i: {k: v[i] for k, v in want.items()} for i in range(2)}
    held = [(i, {k: v[i] for k, v in got.items() if k != "frame_stats"})
            for i in range(2)]
    fetched = [(i, got["frame_stats"][i].numpy()) for i in range(2)]
    ok, table = check.judge(check.compare(held, fetched, ref),
                            c.config["limits"])
    assert not ok, table
    # the float32 reference against itself reads nothing
    same = [(i, {k: v[i] for k, v in want.items() if k != "frame_stats"})
            for i in range(2)]
    ok, table = check.judge(check.compare(
        same, [(i, want["frame_stats"][i].numpy()) for i in range(2)], ref),
        c.config["limits"])
    assert ok and all(v["value"] == 0 for v in table.values()), table


class Broken:
    """The pipeline with one fault planted in what it returns."""

    def __init__(self, pipe, fault):
        self.pipe, self.fault, self.prev = pipe, fault, None

    def _break(self, out, batched):
        if self.fault == "stale":
            # the step hands back its previous state, not this call's
            prev, self.prev = self.prev, out
            return prev if prev is not None else out
        if self.fault == "half_batch":
            # the second half of the batch is left out: its frames get the
            # first half's results
            n = out["disparity"].shape[0]
            return {k: torch.cat([v[:n // 2]] * 2) if n > 1 else v
                    for k, v in out.items()}
        if self.fault == "altered":
            # one answer altered where it is produced: frame 0's disparity
            # is half a pixel off wherever it is valid
            out = dict(out)
            d = out["disparity"].clone()
            d0 = d[0] if batched else d
            d0 += torch.where(d0 >= 0, 0.5, 0.0)
            out["disparity"] = d
            return out
        raise ValueError(self.fault)

    def process_batch(self, lefts, rights):
        return self._break(self.pipe.process_batch(lefts, rights), True)

    def process_pair(self, left, right):
        return self._break(self.pipe.process_pair(left, right), False)


# a live cell's calls hold one pair, so it has no half batch to leave out;
# no cell runs across chips, so none can leave out an exchange
FAULTS = [(name, fault) for name in CELLS
          for fault in ("stale", "half_batch", "altered")
          if not (fault == "half_batch" and "live" in name)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_cell, name, fault):
    c = tiny_cell(name)
    r = cell.run(c, 2 ** 31 + 31, 0.4, False, "cpu", time.perf_counter(),
                 lambda m: None, wrap=lambda p: Broken(p, fault))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("numbers,named", [
    ({"rect_gap": 0.0}, "limits without a number: ['conf_diff_pct'"),
    (dict.fromkeys(check.NAMES + ("voxel_gap",), 0.0),
     "numbers without a limit: ['voxel_gap']")], ids=["missing", "unknown"])
def test_judge_fails_on_a_number_without_its_limit(numbers, named):
    limits = dict.fromkeys(check.NAMES, 1.0)
    with pytest.raises(ValueError, match=re.escape(named)):
        check.judge(numbers, limits)
    ok, table = check.judge(dict.fromkeys(check.NAMES, 0.5), limits)
    assert ok and list(table) == list(check.NAMES)


def test_the_stats_check_sees_a_missing_depth():
    want = np.array([[0.9, 0.8, 3000.0]], np.float32)
    assert check.stats_gap(want, want) == 0.0
    assert check.stats_gap(np.array([[0.9, 0.8, np.nan]]), want) == 1.0
    assert check.stats_gap(np.array([[0.0, 0.8, 3000.0]]), want) == 1.0
    assert check.stats_gap(want * np.float32(1.01), want) == pytest.approx(
        0.01, rel=1e-5)
