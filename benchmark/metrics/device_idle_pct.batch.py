"""device_idle_pct.batch: the share of the traced window (its start to the
last call drained) in which no kernel, copy or set ran on the card, in %."""

from harness import trace as tr


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - tr.busy_us(run.trace) / (hi - lo))
