"""latency_p50_ms: the median of the same requests' latencies as
latency_p95_ms."""

from harness import traffic


def read(run):
    return traffic.percentile_ms(run.calls, 50)
