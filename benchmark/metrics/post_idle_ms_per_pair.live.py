"""post_idle_ms_per_pair.live: device idle ms a request (one pair) while the
host was in ``sdr.post`` (reprojection, the output dict, the stats). The
idle time is device_idle_pct.live's: the request's interval less the union
of its own device operations, split by the innermost program span open on
the host (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.idle_ms_per_pair(run, "post")
