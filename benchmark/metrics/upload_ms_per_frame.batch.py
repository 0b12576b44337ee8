"""upload_ms_per_frame.batch: device ms of the host-to-device copies (the
pipeline's upload of the host frames) a frame, from the trace."""

from harness import trace as tr
from roofline import sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["upload"]:
        return None
    return s["upload"] * 1e-3 / s["frames"]
