"""The 95th percentile of every call's latency in the window, in ms: from
handing the block over on the host to its output back on the host."""

from benchmark.harness import percentile


def read(w):
    return percentile(w.latencies, 95) * 1e3
