"""Kernel launches a block, from the profiler's kernel rows (copies and
sets not counted)."""


def read(t):
    n = t.count("kernel")
    return n / t.calls if n and t.calls else None
