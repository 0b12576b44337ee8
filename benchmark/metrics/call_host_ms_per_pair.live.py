"""call_host_ms_per_pair.live: the mean length of the program's
``sdr.call`` span a pair, in ms: the host's time to enqueue one pair
through process_pair, from the input's conversion to the returned
outputs (profiler clock)."""

from harness import spans


def read(run):
    return spans.call_ms_per_pair(run)
