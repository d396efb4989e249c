"""The median of every call's latency in the window, in ms."""

from benchmark.harness import percentile


def read(w):
    return percentile(w.latencies, 50) * 1e3
