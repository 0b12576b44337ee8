"""matcher_ms_per_frame.batch: device ms a frame (a pair) of the matcher's
kernels (roofline/sgbm.py's names: K1, the aggregation sweeps or passes,
WTA/LR, the speckle filter), both the left and the right matcher."""

from harness import trace as tr
from roofline import sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["matcher"]:
        return None
    return s["matcher"] * 1e-3 / s["frames"]
