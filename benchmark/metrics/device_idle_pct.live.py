"""device_idle_pct.live: the share of the requests' time, each from the
generator's wake at its due time to its stats on the host, in which no
kernel, copy or set of that request ran on the card, in %. The time
between requests, when the camera has delivered nothing, is not counted.
A request's busy time is the union of its own operations' intervals, so
an offset between the trace's host and device clocks does not enter."""

from harness import trace as tr


def read(run):
    if run.trace is None:
        return None
    calls = [c for c in run.trace.calls if c.request is not None]
    total = sum(c.request[1] - c.request[0] for c in calls)
    if not total:
        return None
    busy = sum(b - a for c in calls for a, b in tr.merged(c.ops))
    return 100.0 * (1.0 - busy / total)
