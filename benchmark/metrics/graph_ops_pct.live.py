"""graph_ops_pct.live: the share of the requests' device operations
(kernels, copies, sets) that a CUDA graph's replay launched, in %: those
whose launching runtime call of the main thread (``Trace.host``, matched
by correlation id) is ``cudaGraphLaunch``. CUPTI gives each operation of
a replayed graph the correlation id of its ``cudaGraphLaunch``. A program
that launches no graph reads 0."""

from harness import trace as tr


def read(run):
    if run.trace is None:
        return None
    ops = [o for c in run.trace.calls for o in c.ops]
    if not ops:
        return None
    graph = {o.corr for o in run.trace.host
             if o.cat in tr.RUNTIME_CATS and o.corr is not None
             and o.name.startswith("cudaGraphLaunch")}
    return 100.0 * sum(o.corr in graph for o in ops) / len(ops)
