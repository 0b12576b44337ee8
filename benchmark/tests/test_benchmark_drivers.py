"""The driver contract (drivers/__init__.py) on the CPU: a driver planted in
a directory of its own runs a tiny cell through the unchanged harness, with
its own entry, host outputs whose size varies from frame to frame, and its
own numbers and limits; an entry the driver lacks raises, naming it."""

import copy
import textwrap
import time

import pytest

from harness import cell, inputs

PLANTED = textwrap.dedent('''
    """A driver planted by the contract's test: for each frame of a call
    the program keeps the left frame's pixels brighter than the right
    frame's at the same place, as many as the pair has."""

    import numpy as np
    import torch

    ENTRIES = {"bright_pixels": (2,)}
    NAMES = ("count_gap", "value_gap")


    class Program:
        def __init__(self, device):
            self.device = device

        def run(self, lefts, rights):
            left = torch.as_tensor(lefts, device=self.device)
            right = torch.as_tensor(rights, device=self.device)
            return [a[a > b] for a, b in zip(left, right)]


    def build(config, rig, device):
        return Program(device)


    def call(program, entry, pool, seq, batch):
        pool_l, pool_r = pool

        def fn(slot, pairs):
            return program.run(pool_l[pairs], pool_r[pairs])
        return fn


    def fetch(out):
        return [v.cpu().numpy() for v in out]


    class Holder:
        def __init__(self, checked):
            self.checked = {int(p) for p in checked}
            self.kept = {}

        def prepare(self, out):
            pass

        def offer(self, pairs, out):
            for k, p in enumerate(pairs):
                if int(p) in self.checked:
                    self.kept[int(p)] = out[k]

        def frames(self):
            return sorted(self.kept.items())


    def holder(entry, checked, seed):
        return Holder(checked)


    def compare(held, fetched, pool, rig, config, device):
        pool_l, pool_r = pool
        out = dict.fromkeys(NAMES, 0.0)
        for p, got in [(p, v.cpu().numpy()) for p, v in held] + fetched:
            want = pool_l[p][pool_l[p] > pool_r[p]].astype(np.float64)
            got = np.asarray(got, np.float64)
            out["count_gap"] = max(out["count_gap"],
                                   float(abs(len(got) - len(want))))
            if len(got) == len(want) and len(want):
                out["value_gap"] = max(out["value_gap"],
                                       float(np.abs(got - want).max()))
        return out
''')


class DropsLast:
    """The planted program with its answers altered where they are
    produced: every frame loses its last pixel."""

    def __init__(self, program):
        self.program = program

    def run(self, lefts, rights):
        return [v[:-1] for v in self.program.run(lefts, rights)]


def planted_cell(tiny_cell):
    """A tiny cell of the planted driver: the ZED2 configuration's rig and
    scene at 96 x 64, its own entry at batch 2 and its own limits."""
    like = tiny_cell("hd720_d128_full.batch8")
    cfg = copy.deepcopy(like.config)
    cfg.update(driver="planted", limits={"count_gap": 0.0, "value_gap": 0.0})
    trf = {"mode": "closed", "entry": "bright_pixels", "batch": 2,
           "ahead": 1, "pool": 4, "distinct": 2, "warmup": 1}
    return cell.Cell("planted.bright", 1, cfg, trf, like.end_to_end, [])


@pytest.fixture
def planted(tmp_path, monkeypatch):
    (tmp_path / "planted.py").write_text(PLANTED)
    monkeypatch.setattr(cell, "DRIVERS", tmp_path)


@pytest.mark.parametrize("fault", [None, "drops_last"])
def test_a_planted_driver_runs_a_cell(planted, tiny_cell, fault):
    c = planted_cell(tiny_cell)
    rig_m = inputs.rig(c.config["rig"])
    lefts, rights = inputs.pool(rig_m, c.config, 4, 2 ** 31 + 41, "cpu")
    # the program's host output is of another size for every pair
    assert len({int((a > b).sum()) for a, b in zip(lefts, rights)}) == 4
    r = cell.run(c, 2 ** 31 + 41, 0.4, False, "cpu", time.perf_counter(),
                 lambda m: None, wrap=DropsLast if fault else None)
    assert list(r["checks"]) == ["count_gap", "value_gap"]
    assert set(r["metrics"]) == {"setup_s", "frames_per_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    if fault:
        assert not r["correct"] and r["checks"]["count_gap"]["value"] == 1.0
    else:
        assert r["correct"], r["checks"]
        assert all(v["value"] == 0.0 for v in r["checks"].values())


def test_a_driver_is_found_by_the_configurations_name(planted):
    drv = cell.driver("planted")
    assert drv.ENTRIES == {"bright_pixels": (2,)}
    assert drv.NAMES == ("count_gap", "value_gap")


@pytest.mark.parametrize("entry,batch", [("bright_pixels", 2),
                                         ("process_pair", 2)])
def test_an_entry_the_driver_lacks_raises_naming_the_driver(
        tiny_cell, entry, batch):
    c = tiny_cell("hd720_d128_full.batch8")
    c.traffic = dict(c.traffic, entry=entry, batch=batch)
    with pytest.raises(ValueError, match=r"driver 'pipeline' takes no entry "
                       rf"'{entry}' at batch {batch}; it takes process_batch"
                       r" at batch any, process_pair at batch 1"):
        cell.run(c, 2 ** 31 + 43, 0.2, False, "cpu", time.perf_counter(),
                 lambda m: None)
