"""Phase-vocoder time stretch, vectorized over output frames.

PyTorch counterpart of ``pqmf_tpu/ops/phase_vocoder.py``:

- :func:`stretch_reference` — the reference's per-frame-independent rule
  (``phi = phi0 + omega + a*princarg(phi1 - phi0 - omega)``,
  VocoderPitchShifter.py:176-238), used by ``PhaseVocoderPitchShift``;
- :func:`stretch_accumulate` — torchaudio's running-phase rule, used by
  the torchaudio-variant shifter and wrapper;
- the two omega constructions: :func:`phase_advance_reference` (f32
  stepwise, the reference's) and :func:`phase_advance` (f64 then cast, the
  torchaudio paths'). Each path must use its own: swapping them costs
  parity.

Frame selection is a plain index gather; the JAX package's one-hot matmul
form and its crossover exist only for the TPU's slow minor-dim gathers.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "principal_angle",
    "phase_advance",
    "phase_advance_reference",
    "stretch_reference",
    "stretch_accumulate",
]


def principal_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap angle to [-pi, pi] (reference: VocoderPitchShifter.py:39-47,
    via remainder — matching its edge behavior)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


@functools.lru_cache(maxsize=32)
def phase_advance(n_freq: int, hop_length: int, n_fft: int,
                  device="cpu") -> torch.Tensor:
    """Expected per-hop phase advance per bin, ``2 pi k hop / n_fft``,
    computed in float64 and rounded once to float32 — torchaudio's
    ``linspace(0, pi*hop, n_freq)`` for ``n_freq = n_fft//2 + 1``. The
    omega of the torchaudio-rule paths (:func:`stretch_accumulate`), NOT
    the reference's (:func:`phase_advance_reference`). Cached per
    (geometry, device): callers must not write to it."""
    k = np.arange(n_freq)
    om = 2.0 * np.pi * k * hop_length / n_fft
    return torch.as_tensor(om.astype(np.float32), device=device)


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


def _f32(rate, device) -> torch.Tensor:
    """A stretch rate as float32 on ``device`` (Python floats round once,
    as ``jnp.float32(rate)`` does)."""
    return torch.as_tensor(rate, dtype=torch.float32, device=device)


def _select_frames(p: torch.Tensor, q: torch.Tensor, idx: torch.Tensor):
    """(p, q)[..., idx] along the minor frames axis. p, q: [M, B, F, T];
    idx: [M, O] int64 in range, one index row per band ->
    ([M, B, F, O], [M, B, F, O])."""
    M, B, F_, _ = p.shape
    full = idx[:, None, None, :].expand(M, B, F_, idx.shape[-1])
    return torch.gather(p, -1, full), torch.gather(q, -1, full)


def stretch_reference(mag: torch.Tensor, phase: torch.Tensor, rate,
                      omega: torch.Tensor, frames_out: int):
    """Reference-rule stretch. mag/phase: [B, F, frames]; rate: a scalar;
    omega: [F]. Returns (mag_s, phase_s) with ``frames_out`` frames.

    For j in [0, frames_out): t' = j*rate; t0 = floor(t'); t1 = min(t0+1,
    frames-1); a = t'-t0; mag_j = lerp; phase_j = phi0 + omega +
    a*princarg(phi1 - phi0 - omega)."""
    frames = mag.shape[-1]
    dev = mag.device
    t_prime = torch.arange(frames_out, dtype=torch.float32,
                           device=dev) * _f32(rate, dev)
    t0 = torch.floor(t_prime).to(torch.int64).clamp(0, frames - 1)
    t1 = (t0 + 1).clamp_max(frames - 1)
    a = t_prime - t0.to(torch.float32)

    mag0, phi0 = mag[..., t0], phase[..., t0]
    mag1, phi1 = mag[..., t1], phase[..., t1]
    mag_s = (1.0 - a) * mag0 + a * mag1

    om = omega[None, :, None]
    dp = principal_angle(phi1 - phi0 - om)
    return mag_s, phi0 + om + a * dp


def stretch_accumulate(re: torch.Tensor, im: torch.Tensor, rate,
                       omega: torch.Tensor, frames_out: int):
    """torchaudio's ``phase_vocoder`` (running phase accumulation),
    real-valued: source positions ``t = j*rate``, the spectrum zero-padded
    by two frames on the right, the wrapped per-step phase increment
    summed from the phase of the first sampled frame.

    Two forms:
    - a scalar ``rate``: (re, im) [B, F, frames] -> [B, F, frames_out];
    - one rate per band, ``rate`` [M]: band-major (re, im)
      [M, B, F, frames] -> [M, B, F, frames_out]. ``frames_out`` is then
      the bands' shared maximum: the source frame is clamped into the
      padded spectrum, and the caller masks each band's excess frames.
    """
    dev = re.device
    rates = _f32(rate, dev)
    per_band = rates.ndim == 1
    if not per_band:
        re, im, rates = re[None], im[None], rates.reshape(1)
    frames = re.shape[-1]
    re_p = F.pad(re, (0, 2))
    im_p = F.pad(im, (0, 2))
    t = torch.arange(frames_out, dtype=torch.float32,
                     device=dev)[None, :] * rates[:, None]  # [M, O]
    t0 = torch.floor(t).to(torch.int64)
    alphas = (t - t0.to(torch.float32))[:, None, None, :]
    t0 = t0.clamp_max(frames)

    r0, i0 = _select_frames(re_p, im_p, t0)
    r1, i1 = _select_frames(re_p, im_p, t0 + 1)
    angle_0 = torch.atan2(i0, r0)
    angle_1 = torch.atan2(i1, r1)
    norm_0 = torch.sqrt(r0 * r0 + i0 * i0)
    norm_1 = torch.sqrt(r1 * r1 + i1 * i1)

    # the running phase in float64, from the float32 angles on: it grows
    # by up to pi*hop per frame in the top bins (1.7e5 rad after 434
    # frames of a whole-file band, where a float32 ulp is 0.016 rad), so
    # in float32 a 1e-7 relative change of the input moved the whole-file
    # output to 81 dB; in float64 it stays at 115 dB, and the card, whose
    # matmuls and scan sum in another order, agrees with the CPU
    f64 = torch.float64
    om = omega[None, None, :, None].to(f64)
    phase = angle_1.to(f64) - angle_0.to(f64) - om
    phase = phase - 2.0 * math.pi * torch.round(phase / (2.0 * math.pi))
    phase = phase + om
    incs = torch.cat([angle_0[..., :1].to(f64), phase[..., :-1]], dim=-1)
    # summed over a leading axis: the card's scan along the minor axis ran
    # one 0.41 ms kernel for 16 blocks' ~10 frames (one thread per bin
    # sums its frames in order here, as the CPU does)
    phase_acc = torch.cumsum(incs.transpose(-1, -2), dim=-2).transpose(
        -1, -2)

    mag = (alphas * norm_1 + (1.0 - alphas) * norm_0).to(f64)
    re_s = (mag * torch.cos(phase_acc)).to(torch.float32)
    im_s = (mag * torch.sin(phase_acc)).to(torch.float32)
    if not per_band:
        re_s, im_s = re_s[0], im_s[0]
    return re_s, im_s
