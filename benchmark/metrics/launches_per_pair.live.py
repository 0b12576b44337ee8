"""launches_per_pair.live: device operations (kernels of every kind,
copies and sets) that a request issued, from submit to its stats fetch,
on average over the requests (profiler trace)."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    calls = run.trace.calls
    return sum(len(c.ops) for c in calls) / len(calls)
