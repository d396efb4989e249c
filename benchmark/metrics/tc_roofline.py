"""K1t + K2t's share of their roofline, in %: the least time the card
could take for their work a call (``roofline_tier.conv_pair``: the
analysis and synthesis of the call's blocks, counted from the
configuration's shapes, at the bf16 tensor-core peak or the HBM rate)
over their device time a call (the kernels named ``conv_tc_kernel``).
None where no such kernel ran (a ``highest`` step runs K1/K2)."""

from benchmark import roofline_tier

KERNEL = "conv_tc_kernel"


def read(t):
    s = sum(sec for n, c, sec in t.ops if c == "kernel" and KERNEL in n)
    if not s:
        return None
    c = t.context
    bound_s, _ = roofline_tier.conv_pair(c["config"], c["rows"], c["block"])
    return 100.0 * bound_s / (s / t.calls)
