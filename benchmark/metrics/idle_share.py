"""The device's idle share of a call, in %: 1 - its device-busy seconds
(the traced slice: the union of kernels, copies and sets) / its wall
seconds (the run's untraced window). The profiler slows the host (up to
~0.7 ms a call), so the slice's own wall time would count its cost as
idle. None without device work."""


def read(t):
    if t.busy_s <= 0:
        return None
    w = t.context["window"]
    return 100.0 * (1.0 - (t.busy_s / t.calls) / (w.window_s / w.calls))
