"""Phase-vocoder pieces of the flagship stretch.

PyTorch counterpart of ``pqmf_tpu/ops/phase_vocoder.py:46-143``: the phase
wrap, the reference's omega construction and the frame selection. Frame
selection is a plain index gather; the JAX package's one-hot matmul form
and its crossover exist only for the TPU's slow minor-dim gathers.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["principal_angle", "phase_advance_reference"]


def principal_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap angle to [-pi, pi] (reference: VocoderPitchShifter.py:39-47,
    via remainder — matching its edge behavior)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


@functools.lru_cache(maxsize=32)
def phase_advance_reference(n_freq: int, hop_length: int, n_fft: int,
                            device="cpu") -> torch.Tensor:
    """Bit-exact transcription of the reference's omega construction
    (VocoderPitchShifter.py:197-198): float32 STEPWISE
    ``2.0*pi * k * hop / n_fft``. The float64-then-cast values differ by
    1 ulp on about a third of the bins, and the stretch's boundary-clamped
    frames feed ``princarg(-omega)`` exactly at the ±pi wrap, where that
    ulp flips the branch (25-60 dB on shifts +6/+7/+9). Cached per
    (geometry, device): callers must not write to it."""
    k = np.arange(n_freq, dtype=np.float32)
    om = np.float32(2.0 * math.pi) * k * np.float32(hop_length)
    return torch.as_tensor(om / np.float32(n_fft), device=device)


def _select_frames(p: torch.Tensor, q: torch.Tensor, idx: torch.Tensor):
    """(p, q)[..., idx] along the minor frames axis. p, q: [M, B, F, T];
    idx: [M, O] int64 in range, one index row per band ->
    ([M, B, F, O], [M, B, F, O])."""
    M, B, F_, _ = p.shape
    full = idx[:, None, None, :].expand(M, B, F_, idx.shape[-1])
    return torch.gather(p, -1, full), torch.gather(q, -1, full)
