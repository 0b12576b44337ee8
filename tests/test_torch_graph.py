"""``StereoPipeline.process_pair``'s captured CUDA graph: the rule that
decides when a call runs eagerly, captures or replays (``_graph_step``),
the CPU path that never captures, and on the card the replays against the
eager ``_forward`` bit for bit for every configuration branch.

The card cases are marked ``cuda`` and skip without a card. The file
needs nothing from tests/conftest.py (which imports JAX), so on a machine
with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_graph.py``.
"""

import numpy as np
import pytest
import torch

from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch import pipeline as tp
from stereo_depth_ruler_tpu_torch.ops import sgbm_cuda as sc
from stereo_depth_ruler_tpu_torch.ops import wls_cuda as wc

A = ((1, 24, 32), torch.uint8, (1, 24, 32), torch.uint8)
B = ((1, 24, 32), torch.float32, (1, 24, 32), torch.float32)


@pytest.mark.parametrize("held,last,sig,step", [
    (None, None, A, "eager"),       # the first call
    (None, A, A, "capture"),        # its repeat
    (A, A, A, "replay"),            # the third call
    (A, A, B, "eager"),             # one call with another signature
    (A, B, B, "capture"),           # twice: its graph replaces the held one
    (A, B, A, "replay"),            # back to the first signature
], ids=["first", "repeat", "third", "other_once", "other_twice",
        "back_to_first"])
def test_graph_step(held, last, sig, step):
    assert tp._graph_step(held, last, sig) == step


# the branches of PipelineConfig that process_pair runs, as
# (config fields, rectify, colour input)
BRANCHES = {
    "stacked_wls": (dict(), True, False),
    "shared_wls": (dict(pair_mode="shared"), True, False),
    "no_wls": (dict(use_wls=False), True, False),
    "fast_lr": (dict(use_wls=False, lr_mode="fast"), True, False),
    "no_lr": (dict(use_wls=False, lr_mode="none"), True, False),
    "colour": (dict(), True, True),
    "downscale2": (dict(downscale=2), True, False),
    "no_rectify": (dict(), False, False),
}


def _pipeline(name, device, w, h, D):
    fields, rectify, _ = BRANCHES[name]
    fields = {"downscale": 1, **fields}
    params = SGBMParams(num_disparities=D, speckle_window_size=20,
                        speckle_range=2)
    rig = StereoRig.synthetic(width=w, height=h)
    return tp.StereoPipeline(rig, tp.PipelineConfig(sgbm=params, **fields),
                             rectify=rectify, device=device)


def _pairs(name, n, w, h, shift=5):
    """n distinct uint8 pairs (H, W[, 3]), the right a shifted left."""
    colour = BRANCHES[name][2]
    rng = np.random.default_rng(w + h)
    shape = (n, h, w, 3) if colour else (n, h, w)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    return [(left[i], np.roll(left[i], -shift, axis=1)) for i in range(n)]


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        # bit for bit; a frame with no valid depth has a NaN mean depth
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def _eager(pipe, left, right):
    out = pipe._forward(torch.as_tensor(left)[None],
                        torch.as_tensor(right)[None])
    return {k: v[0] for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_process_pair_on_the_cpu_never_captures(name):
    pipe = _pipeline(name, "cpu", 32, 24, 16)
    tp.reset_graph_counts()
    for left, right in _pairs(name, 3, 32, 24):
        _assert_equal(pipe.process_pair(left, right),
                      _eager(pipe, left, right))
    assert tp.GRAPH_CALLS == {"eager": 3, "captured": 0, "replayed": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_replays_equal_the_eager_forward(cuda, name):
    """The first call runs eagerly, the second captures, the rest replay:
    every output of each equals the eager ``_forward`` on the same pair."""
    pipe = _pipeline(name, cuda, 160, 96, 32)
    pairs = _pairs(name, 4, 160, 96)
    tp.reset_graph_counts()
    got = [pipe.process_pair(left, right) for left, right in pairs]
    assert tp.GRAPH_CALLS == {"eager": 1, "captured": 1, "replayed": 2}
    for out, (left, right) in zip(got, pairs):
        _assert_equal(out, _eager(pipe, left, right))
    assert (got[3]["disparity"] >= 0).float().mean() > 0.5


@pytest.mark.cuda
def test_replays_equal_the_eager_forward_at_hd720(cuda):
    """The benchmark's configuration: 1280x720, 128 disparities, speckle
    200/2, the right matcher and WLS."""
    params = SGBMParams(num_disparities=128, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    rig = StereoRig.synthetic(width=1280, height=720)
    pipe = tp.StereoPipeline(rig, tp.PipelineConfig(sgbm=params,
                                                    downscale=1),
                             device=cuda)
    pairs = _pairs("stacked_wls", 4, 1280, 720, shift=40)
    got = [pipe.process_pair(left, right) for left, right in pairs]
    for out, (left, right) in zip(got, pairs):
        _assert_equal(out, _eager(pipe, left, right))


@pytest.mark.cuda
def test_a_replays_outputs_outlive_the_next_replay(cuda):
    """The outputs of pair k are the caller's: submitting pair k + 1 leaves
    them as they were."""
    pipe = _pipeline("stacked_wls", cuda, 160, 96, 32)
    pairs = _pairs("stacked_wls", 5, 160, 96)
    outs, kept = [], []
    for left, right in pairs:
        outs.append(pipe.process_pair(left, right))
        kept.append({k: v.clone() for k, v in outs[-1].items()})
    for out, want in zip(outs, kept):
        _assert_equal(out, want)
    assert not torch.equal(outs[3]["disparity"], outs[4]["disparity"])


@pytest.mark.cuda
def test_capture_on_the_second_call_and_another_signature_runs_eagerly(
        cuda):
    """uint8 pairs (signature u) and the same pairs as float32 (f): u u u f
    u f f f run eager, capture, replay, eager, replay, eager, capture,
    replay, and every output equals the eager forward's."""
    pipe = _pipeline("stacked_wls", cuda, 160, 96, 32)
    pairs = _pairs("stacked_wls", 8, 160, 96)
    steps = []
    for (left, right), sig in zip(pairs, "uuufufff"):
        if sig == "f":
            left, right = np.float32(left), np.float32(right)
        before = dict(tp.GRAPH_CALLS)
        out = pipe.process_pair(left, right)
        steps += [k for k in before if tp.GRAPH_CALLS[k] != before[k]]
        _assert_equal(out, _eager(pipe, left, right))
    assert steps == ["eager", "captured", "replayed", "eager", "replayed",
                     "eager", "captured", "replayed"]


@pytest.mark.cuda
def test_replays_leave_the_launch_counts_unchanged(cuda):
    """The ops' LAUNCHES count the eager call and the capture alike, and no
    replay."""
    pipe = _pipeline("stacked_wls", cuda, 160, 96, 32)
    pairs = _pairs("stacked_wls", 5, 160, 96)
    sc.reset_launch_counts()
    wc.reset_launch_counts()
    counts = []
    for left, right in pairs:
        pipe.process_pair(left, right)
        counts.append({**sc.LAUNCHES, **wc.LAUNCHES})
    once = counts[0]
    assert any(once.values())
    assert counts[1] == {k: 2 * v for k, v in once.items()}
    assert counts[2] == counts[3] == counts[4] == counts[1]
