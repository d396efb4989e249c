"""Plain reference of the flagship pitch shifter (the reference's
``PQMFPitchShiftWrapper``, ``1-PitchShifterWrapper.py``): the cached
analysis, then in every band its own phase-vocoder pitch shift, a
crossfade against the tail the band kept from the previous block, and the
cached synthesis.

In each band of ``Tb`` samples, shifted by ``s`` semitones (rate
``r = 2 ** (-s / 12)``): a centred, normalised STFT (``torch.stft``, Hann
window); ``floor(frames / r)`` output frames, frame ``j`` read at
``t' = j r`` with the magnitude interpolated between frames ``t0 =
floor(t')`` and ``t1 = t0 + 1`` (both clamped to the last frame) and the
phase ``phi0 + omega + a * princarg(phi1 - phi0 - omega)`` (``a = t' -
t0``, ``omega`` the bin's advance a hop, stepped in float32 as the
reference computes it); ``torch.istft``; the result centred in
``(frames_out - 1) * hop + n_fft`` samples and linearly resampled to
``Tb`` (``F.interpolate``). The first ``L`` samples of the band are then
``tail * fade_out + y[:L] * fade_in`` (the two halves of a Hann window of
``2 L``) and the band keeps ``y[Tb - L:]`` as the next block's tail.

So a block's output depends on its own input and on the previous block's:
:func:`step` takes both (``None`` for a stream's first block).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import bank

__all__ = ["geometry", "shifted_bands", "step"]


def geometry(m_buffer_size: int, n_band: int) -> dict:
    """The wrapper's STFT geometry from its buffer size
    (``1-PitchShifterWrapper.py:137-151``)."""
    sub = max(16, m_buffer_size // max(1, n_band))
    win = max(16, min(sub, 4096))
    hop = max(1, win // 4)
    n_fft = max(min(1 << (win - 1).bit_length(), 4096), win)
    return {"win": win, "hop": hop, "n_fft": n_fft,
            "crossfade": min(hop, max(0, win // 4))}


def _princarg(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def _omega(n_freq: int, hop: int, n_fft: int, device) -> torch.Tensor:
    k = np.arange(n_freq, dtype=np.float32)
    om = np.float32(2.0 * math.pi) * k * np.float32(hop) / np.float32(n_fft)
    return torch.as_tensor(om, device=device)


def _shift_band(xb, semitones, geo, tf32):
    """One band's phase-vocoder shift of rows xb [R, Tb] -> [R, Tb]."""
    n_fft, hop, win = geo["n_fft"], geo["hop"], geo["win"]
    R, Tb = xb.shape
    dev = xb.device
    if Tb < n_fft:
        xb = F.pad(xb, (0, n_fft - Tb))
    window = torch.hann_window(win, dtype=xb.dtype, device=dev)
    if tf32:
        xb = bank.to_tf32(xb)
    spec = torch.stft(xb, n_fft, hop, win_length=win, window=window,
                      center=True, pad_mode="constant", normalized=True,
                      return_complex=True)
    re, im = spec.real, spec.imag
    frames = spec.shape[-1]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    phase = torch.atan2(im, re)

    rate = 1.0 / (2.0 ** (int(round(semitones)) / 12.0))
    frames_out = max(1, int(math.floor(frames / rate)))
    if frames_out == 1:
        raise ValueError("a one-frame stretch is not in this reference")
    tp = (torch.arange(frames_out, dtype=torch.float32, device=dev)
          * torch.tensor(rate, dtype=torch.float32, device=dev))
    t0 = torch.floor(tp).long().clamp(0, frames - 1)
    t1 = (t0 + 1).clamp_max(frames - 1)
    a = (tp - t0.float()).to(xb.dtype)
    om = _omega(spec.shape[1], hop, n_fft, dev)[:, None].to(xb.dtype)
    phi0, phi1 = phase[..., t0], phase[..., t1]
    mag_s = (1 - a) * mag[..., t0] + a * mag[..., t1]
    phi = phi0 + om + a * _princarg(phi1 - phi0 - om)
    re_s, im_s = mag_s * torch.cos(phi), mag_s * torch.sin(phi)
    if tf32:
        re_s, im_s = bank.to_tf32(re_s), bank.to_tf32(im_s)
    y = torch.istft(torch.complex(re_s, im_s), n_fft, hop, win_length=win,
                    window=window, center=True, normalized=True)
    y = F.pad(y, (n_fft // 2, n_fft // 2))  # centred in (fo - 1) hop + n_fft
    return F.interpolate(y[:, None, :], size=Tb, mode="linear",
                         align_corners=False)[:, 0, :]


def shifted_bands(x: torch.Tensor, hk, shifts, geo: dict,
                  tf32: bool = False) -> torch.Tensor:
    """Blocks x [R, T] -> every band shifted, before the crossfade:
    [R, M, T/M]."""
    sub = bank.analysis(x, hk, tf32=tf32)
    return torch.stack([_shift_band(sub[:, m], shifts[m], geo, tf32)
                        for m in range(sub.shape[1])], dim=1)


def step(x: torch.Tensor, x_prev, hk, shifts, geo: dict,
         tf32: bool = False) -> torch.Tensor:
    """The output [R, T] of blocks x [R, T] of R streams whose previous
    blocks were ``x_prev`` [R, T] (``None``: each stream's first block,
    whose carried tail is zero)."""
    y = shifted_bands(x, hk, shifts, geo, tf32)
    L = geo["crossfade"]
    if L > 0:
        if x_prev is None:
            tail = torch.zeros_like(y[..., :L])
        else:
            tail = shifted_bands(x_prev, hk, shifts, geo, tf32)[..., -L:]
        fade = torch.hann_window(2 * L, dtype=x.dtype, device=x.device)
        head = tail * fade[:L] + y[..., :L] * fade[L:]
        y = torch.cat([head, y[..., L:]], dim=-1)
    return bank.synthesis(y, hk, tf32=tf32)
