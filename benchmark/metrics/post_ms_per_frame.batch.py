"""post_ms_per_frame.batch: device ms a frame of the operations of a call
after its last matcher or WLS kernel, other than copies: the WLS ratio,
reprojection (ops/reproject.py) and the frame stats (metrics.py)."""

from harness import trace as tr
from roofline import sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["post"]:
        return None
    return s["post"] * 1e-3 / s["frames"]
