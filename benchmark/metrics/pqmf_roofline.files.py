"""The offline round trip's share of its roofline, in %: the least time
the card could take for a call's work over the device's busy time a call.

The work is counted once from the configuration's shapes, whatever kernel
does it: the polyphase analysis and synthesis need B T M L multiply-adds
each (B clips of T samples, M bands, L = P / M taps a phase of the bank
of P taps), 2 FLOP each at the card's float32 peak; the bytes are the
signal read and written once and both banks read once, at its HBM rate.
The larger of the two times is the bound (``roofline.bound``)."""

from benchmark import roofline


def read(t):
    if not t.count("kernel"):
        return None
    c = t.context
    bound_s, _ = roofline.polyphase_roundtrip(c["config"], c["rows"],
                                              c["block"])
    return 100.0 * bound_s / (t.busy_s / t.calls)
