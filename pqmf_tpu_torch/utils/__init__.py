"""Host-side utilities of the port (NumPy only)."""

from pqmf_tpu_torch.utils import metrics

__all__ = ["metrics"]
