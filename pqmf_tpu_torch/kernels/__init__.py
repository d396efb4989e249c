"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``) and their
wrappers; see ``cached_conv``."""

from pqmf_tpu_torch.kernels import cached_conv

__all__ = ["cached_conv"]
