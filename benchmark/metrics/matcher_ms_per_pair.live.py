"""matcher_ms_per_pair.live: device ms a request (one pair) of the
matcher's kernels (roofline/sgbm.py's names), both matchers."""

from harness import trace as tr
from roofline import sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["matcher"]:
        return None
    return s["matcher"] * 1e-3 / s["frames"]
