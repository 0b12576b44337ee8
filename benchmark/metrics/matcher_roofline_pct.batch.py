"""matcher_roofline_pct.batch: the matcher's share of its roofline, in %:
the least time the card could take for the work the algorithm needs
(roofline/sgbm.py's operations and bytes for every matcher frame of the
window: two a pair with the right matcher), over the device time of the
matcher's kernels. Peaks: roofline/peaks.py (H100 SXM at 700 W)."""

from harness import trace as tr
from roofline import peaks, sgbm, wls


def read(run):
    if run.trace is None:
        return None
    s = tr.stage_sums(run.trace, sgbm.KERNELS, wls.KERNELS)
    if not s["frames"] or not s["matcher"]:
        return None
    cfg, p = run.config, run.config["sgbm"]
    ds = cfg["pipeline"]["downscale"]
    H, W = cfg["rig"]["height"] // ds, cfg["rig"]["width"] // ds
    right = cfg["pipeline"]["use_wls"] and \
        cfg["pipeline"]["lr_mode"] == "right_matcher"
    frames = s["frames"] * (2 if right else 1)
    return peaks.share_pct(
        sgbm.ops(frames, H, W, p["num_disparities"], p["num_paths"],
                 p["block_size"]),
        sgbm.nbytes(frames, H, W), s["matcher"] * 1e-6)
