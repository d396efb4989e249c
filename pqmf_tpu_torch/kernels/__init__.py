"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``) and their
wrappers: ``cached_conv`` (K1/K2/K3) and the polyphase adapters over them,
``polyphase`` (K4/K5/K6)."""

from pqmf_tpu_torch.kernels import cached_conv, polyphase

__all__ = ["cached_conv", "polyphase"]
