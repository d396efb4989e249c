"""Utilities of the port: ``audio`` and ``metrics`` (host-side NumPy) and
``profiling`` (torch timing, imported by name)."""

from pqmf_tpu_torch.utils import audio, metrics

__all__ = ["audio", "metrics"]
