"""``graph_ops_pct.live`` on synthetic traces: the share of the requests'
device operations whose launching runtime call is a graph launch."""

import pytest

from harness import cell, trace as tr


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def live_trace(graph: bool, requests: int = 2):
    """Open-loop requests of 1000 us, 2000 us apart: two upload copies, then
    five kernels (with ``graph``, of one ``cudaGraphLaunch``; else each of
    its own ``cudaLaunchKernel``), then the stats' copy to the host."""
    ev = [_ev("bench.window", "user_annotation", 0, 2000 * requests)]
    corr = 0
    for i in range(requests):
        base = 2000 * i
        ev.append(_ev("bench.request", "user_annotation", base, 1000))
        ev.append(_ev("bench.submit", "user_annotation", base + 10, 490))
        ev.append(_ev("bench.fetch", "user_annotation", base + 600, 390))
        launches = [("cudaMemcpyAsync", 20, ["Memcpy HtoD (Pageable -> "
                                             "Device)"]),
                    ("cudaMemcpyAsync", 30, ["Memcpy HtoD (Pageable -> "
                                             "Device)"])]
        kernels = [f"void k{j}()" for j in range(5)]
        if graph:
            launches.append(("cudaGraphLaunch", 40, kernels))
        else:
            launches += [("cudaLaunchKernel", 40 + j, [k])
                         for j, k in enumerate(kernels)]
        launches.append(("cudaMemcpyAsync", 610, ["Memcpy DtoH (Device -> "
                                                  "Pageable)"]))
        for name, host, ops in launches:
            corr += 1
            ev.append(_ev(name, "cuda_runtime", base + host, 1, corr=corr))
            for j, op in enumerate(ops):
                ev.append(_ev(op, "gpu_memcpy" if "Memcpy" in op else
                              "kernel", base + host + 5 + 20 * j, 10, tid=7,
                              corr=corr))
    return tr.build(ev, [1] * requests)


def _read(t):
    return cell.reader("graph_ops_pct.live")(
        cell.Measured({}, {}, 1.0, 0.0, [], 0.0, 0, trace=t))


@pytest.mark.parametrize("graph,want", [(True, 62.5), (False, 0.0)],
                         ids=["replayed", "eager"])
def test_graph_ops_share(graph, want):
    """Five of each request's eight operations came from the graph launch;
    an eager program's read 0."""
    t = live_trace(graph)
    assert sum(len(c.ops) for c in t.calls) == 16
    assert _read(t) == pytest.approx(want)


def test_graph_ops_share_reads_nothing_without_operations():
    assert _read(None) is None
    t = live_trace(True)
    for c in t.calls:
        c.ops = []
    assert _read(t) is None
