"""K3's thread-block cluster kernel's share of its roofline, in %: the
least time the card could take for a call's round trip (``roofline.
polyphase_roundtrip_work`` of the call's clips with the M bands and P
taps of the configuration's own bank, the committed file its
``weights`` names, at the float32 peak or the HBM rate) over the device
time a call of the kernels named ``roundtrip_cluster_kernel`` (K3 at
M >= 32). None where no such kernel ran."""

from benchmark import roofline
from benchmark.reference import tuned_bank

KERNEL = "roundtrip_cluster_kernel"


def read(t):
    s = sum(sec for n, c, sec in t.ops if c == "kernel" and KERNEL in n)
    if not s:
        return None
    c = t.context
    M, P = tuned_bank.load(c["config"]["weights"]).shape
    bound_s, _ = roofline.bound_seconds(
        *roofline.polyphase_roundtrip_work(c["rows"], c["block"], M, P))
    return 100.0 * bound_s / (s / t.calls)
