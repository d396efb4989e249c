"""Host-side utilities of the port (NumPy only)."""

from pqmf_tpu_torch.utils import audio, metrics

__all__ = ["audio", "metrics"]
