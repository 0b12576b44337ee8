"""prep_ms_per_frame.batch: device ms a frame of the operations of a call
before its first matcher kernel, other than the upload: gray conversion,
rectification and downscale (ops/remap.py, pipeline.py), the pair's
stacking and the matcher's Sobel prefilter."""

from harness import trace as tr
from roofline import sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["prep"]:
        return None
    return s["prep"] * 1e-3 / s["frames"]
