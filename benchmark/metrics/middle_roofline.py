"""The middle's share of the roofline of its two DFT products, in %: the
least time the card could take for the products' work a call
(``roofline_tier.dft_products``: the STFT over every frame and the ISTFT
over the frames that exist, counted from the configuration's shapes, at
the bf16 tensor-core peak or the HBM rate) over the middle's device time
a call (``middle_ms``: every kernel not in ``metrics.PQMF_KERNELS``)."""

from benchmark import roofline_tier
from benchmark.metrics import PQMF_KERNELS


def read(t):
    s = t.seconds("kernel", exclude=PQMF_KERNELS)
    if not s:
        return None
    c = t.context
    bound_s, _ = roofline_tier.dft_products(c["config"], c["rows"],
                                            c["block"])
    return 100.0 * bound_s / (s / t.calls)
