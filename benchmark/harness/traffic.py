"""The one traffic generator: it reads a traffic file's parameters and
drives a submit / fetch pair of functions.

- ``"mode": "closed"``: batches of ``batch`` pairs back to back, with
  ``ahead`` calls in flight before the oldest one's stats are fetched (the
  CLI's loop: dispatch batch N + 1, then fetch batch N's stats). Calls are
  submitted while the window is open; those in flight at its close are
  drained afterwards and count as done when their stats arrived.
- ``"mode": "open"``: one call due every 1 / ``rate_hz`` seconds from the
  window's start, for every due time inside the window, whatever the
  system's pace. Each call is timed from its due time, so a stall delays
  the calls behind it, and the generator's lateness (start minus due) is
  kept beside it.

Which pool pairs a call takes comes from ``order``, a sequence made from
the seed; every seed gets the same sizes and counts, in another order.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Call:
    index: int
    slot: int                # which of the ``distinct`` calls it repeats
    pairs: np.ndarray        # pool indices of the call's frames
    due: float               # host clock, seconds
    start: float
    done: float = float("nan")
    stats: Optional[object] = None   # the driver's fetch: an item a frame

    @property
    def latency(self) -> float:
        return self.done - self.due

    @property
    def lateness(self) -> float:
        return self.start - self.due


def order(pool: int, length: int, seed: int) -> np.ndarray:
    """``length`` pool indices: seeded permutations of the pool, one after
    another, so every pair occurs as often as every other."""
    rng = np.random.default_rng([seed % (1 << 64), 1])
    reps = -(-length // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:length]


SPIN_S = 10e-3


def sleep_until(t: float, clock: Callable[[], float] = time.perf_counter,
                sleep: Callable[[float], None] = time.sleep,
                spin: float = SPIN_S) -> None:
    """Sleep to within ``spin`` seconds of ``t``, then spin to it. A thread
    woken from a sleep on a shared host can come milliseconds late (on an
    H100 machine's host, a 1 ms margin left 13 to 48 of 600 calls due at
    30/s starting over 1 ms late), and the call's latency, timed from its
    due time, would count the generator's oversleep."""
    left = t - clock()
    if left > spin:
        sleep(left - spin)
    while clock() < t:
        pass


def run(traffic: dict, seconds: float, submit, fetch, seq: np.ndarray,
        clock: Callable[[], float] = time.perf_counter,
        wait: Callable[[float], None] = sleep_until,
        span: Callable[[str], object] = lambda name: nullcontext()
        ) -> tuple:
    """Drive ``submit(call) -> handle`` and ``fetch(handle) -> stats`` with
    the traffic's pattern for ``seconds``. ``seq`` is the pool order: call
    i repeats slot i mod (len(seq) / ``batch``), whose pairs are the slot's
    ``batch`` entries of ``seq``. ``span(name)`` is a context around each
    step for the trace. Returns (window start, calls in order)."""
    batch = int(traffic["batch"])
    slots = len(seq) // batch

    def slot(i):
        k = i % slots
        return k, seq[k * batch:(k + 1) * batch]

    if traffic["mode"] == "closed":
        return _closed(int(traffic["ahead"]), seconds, submit, fetch, slot,
                       clock, span)
    if traffic["mode"] == "open":
        return _open(float(traffic["rate_hz"]), seconds, submit, fetch,
                     slot, clock, wait, span)
    raise ValueError(f"unknown traffic mode {traffic['mode']!r}")


def _closed(ahead, seconds, submit, fetch, slot, clock, span):
    calls: List[Call] = []
    pending = deque()

    def finish():
        call, handle = pending.popleft()
        with span("bench.fetch"):
            call.stats = fetch(handle)
        call.done = clock()

    t0 = clock()
    i = 0
    while clock() - t0 < seconds:
        now = clock()
        call = Call(i, *slot(i), now, now)
        with span("bench.submit"):
            pending.append((call, submit(call)))
        calls.append(call)
        i += 1
        if len(pending) > ahead:
            finish()
    while pending:
        finish()
    return t0, calls


def _open(rate, seconds, submit, fetch, slot, clock, wait, span):
    calls: List[Call] = []
    n = int(np.ceil(seconds * rate))
    t0 = clock()
    for i in range(n):
        due = t0 + i / rate
        with span("bench.sleep"):
            wait(due)
        call = Call(i, *slot(i), due, clock())
        with span("bench.request"):
            with span("bench.submit"):
                handle = submit(call)
            with span("bench.fetch"):
                call.stats = fetch(handle)
        call.done = clock()
        calls.append(call)
    return t0, calls


def frames_per_s(t0: float, seconds: float, calls: List[Call]) -> float:
    """All frames whose stats reached the host inside the window, over the
    window's length."""
    n = sum(len(c.pairs) for c in calls if c.done - t0 <= seconds)
    return n / seconds


def percentile_ms(calls: List[Call], q: float) -> float:
    """The q-th percentile of every call's latency, in ms (linear between
    order statistics)."""
    return float(np.percentile([c.latency for c in calls], q)) * 1e3
