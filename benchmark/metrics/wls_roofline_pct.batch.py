"""wls_roofline_pct.batch: the WLS filter's share of its roofline, in %:
roofline/wls.py's operations and bytes for every frame of the window over
the device time of the filter's kernels. Peaks: roofline/peaks.py (H100
SXM at 700 W)."""

from harness import trace as tr
from roofline import peaks, sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["wls"]:
        return None
    cfg = run.config
    ds = cfg["pipeline"]["downscale"]
    H, W = cfg["rig"]["height"] // ds, cfg["rig"]["width"] // ds
    return peaks.share_pct(wls.ops(s["frames"], H, W, cfg["wls"]["iters"]),
                           wls.nbytes(s["frames"], H, W), s["wls"] * 1e-6)
