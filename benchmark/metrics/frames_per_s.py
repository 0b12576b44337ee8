"""frames_per_s: every frame whose stats reached the host inside the
window, over the window's seconds (host clock)."""

from harness import traffic


def read(run):
    return traffic.frames_per_s(run.t0, run.seconds, run.calls)
