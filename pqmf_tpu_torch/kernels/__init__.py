"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``) and their
wrappers: ``cached_conv`` (K1/K2/K3) and the polyphase adapters over them,
``polyphase`` (K4/K5/K6), whose public ops are exported here as the JAX
package's ``kernels`` exports them, and ``middle``, the flagship pitch
shifter's middle (the JAX package leaves it to XLA)."""

from pqmf_tpu_torch.kernels import cached_conv, middle, polyphase
from pqmf_tpu_torch.kernels.polyphase import (
    polyphase_analysis,
    polyphase_roundtrip,
    polyphase_synthesis,
    roundtrip_supported,
)

__all__ = ["cached_conv", "middle", "polyphase", "polyphase_analysis",
           "polyphase_synthesis", "polyphase_roundtrip",
           "roundtrip_supported"]
