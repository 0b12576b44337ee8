"""latency_p95_ms: the 95th percentile, over every request due in the
window, of the time from its due time to its stats on the host (host
clock)."""

from harness import traffic


def read(run):
    return traffic.percentile_ms(run.calls, 95)
