"""Plain reference of the flagship pitch shifter at its fast-serving tier
(``precision="default"``): ``pitch_shift`` with the tier's roundings.

The tier rounds the operands of the four products of a step to bfloat16
(nearest even) and keeps every sum in float32; everything between the
products stays float32 (``benchmark/configs/pvoc16_fast.json``, ``tier``):

- the analysis: the input block and the analysis bank ``hk``, then the
  sign mask;
- the STFT product: the windowed frames (the Hann window applied in
  float32 first) and the DFT basis ``[cos | sin]`` (float64, rounded to
  float32, then to bfloat16); the ``1/sqrt(n_fft)`` scale after the sum;
- the ISTFT product: the stretched spectrum rows ``[re | im]`` and the
  inverse basis ``[w cos ; -w sin]`` (``w`` = 2/n_fft, 1/n_fft at DC and
  Nyquist; float64, to float32, to bfloat16); ``sqrt(n_fft)`` and the
  window after the sum;
- the synthesis: the crossfaded bands and the synthesis bank (``hk``
  rearranged), the gain ``M`` after the sum.

A product of two bfloat16 values is exact in float32, so each product is
the tier up to the order of its sums. Departures from
``reference/pitch_shift.py``, whose arithmetic this follows otherwise:

- the STFT and ISTFT are explicit DFT products over the whole sequence
  (every frame of every band, no cache, no batching) in place of
  ``torch.stft`` / ``torch.istft``, so that their operands can be rounded;
- the Hann windows (the STFT's and the crossfade's) are evaluated in
  float64 and rounded once to float32 (the tier rounds the windowed frames
  and the crossfaded bands, so a window's last bit shows);
- the convolutions take their operands rounded by the caller and run in
  float32 (``bank.analysis`` / ``bank.synthesis`` on rounded inputs).

``rounding``: ``"tier"`` (the above), ``"none"`` (no rounding: the float32
computation, ``pitch_shift.step`` within the gap of two summation
orders) or ``"control"`` (the tier, with each product's result rounded to
bfloat16 too: what a program with bfloat16 outputs or sums would give).

Plain ``torch``, float32 with TF32 off; nothing of ``pqmf_tpu_torch`` nor
of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import bank
from benchmark.reference.pitch_shift import _omega, _princarg, geometry

__all__ = ["ROUNDINGS", "to_bf16", "step", "shifted_bands", "geometry"]

ROUNDINGS = ("none", "tier", "control")


def to_bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to bfloat16's 8 significant bits, nearest
    even, as float32."""
    return a.to(torch.bfloat16).to(a.dtype)


class _Round:
    """The roundings of one ``rounding`` mode: ``operand`` rounds what the
    tier rounds, ``result`` what only the control rounds."""

    def __init__(self, rounding: str):
        if rounding not in ROUNDINGS:
            raise ValueError(f"rounding {rounding!r} is not one of "
                             f"{ROUNDINGS}")
        self.ops = rounding != "none"
        self.results = rounding == "control"

    def operand(self, a):
        return to_bf16(a) if self.ops else a

    def result(self, a):
        return to_bf16(a) if self.results else a

    def bank(self, hk) -> np.ndarray:
        hk = torch.as_tensor(np.asarray(hk, np.float32))
        return self.operand(hk).numpy()


def _window(win: int, n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window of ``win`` samples (float64, rounded once),
    centred in ``n_fft``."""
    w = torch.hann_window(win, dtype=torch.float64).float()
    left = (n_fft - win) // 2
    return F.pad(w, (left, n_fft - win - left)).to(device)


def _bases(n_fft: int, device) -> tuple:
    """``[cos | sin]`` [n_fft, 2F] and ``[w cos ; -w sin]`` [2F, n_fft]."""
    n = torch.arange(n_fft, dtype=torch.float64)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
    ang = 2.0 * math.pi * torch.outer(n, k) / n_fft            # [n_fft, F]
    w = torch.full((k.shape[0], 1), 2.0 / n_fft, dtype=torch.float64)
    w[0] = w[-1] = 1.0 / n_fft
    fwd = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
    inv = torch.cat([w * torch.cos(ang.T), -w * torch.sin(ang.T)], dim=0)
    return fwd.float().to(device), inv.float().to(device)


def _product(a, b, rnd: _Round):
    with bank.exact_f32():
        return rnd.result(torch.matmul(rnd.operand(a), rnd.operand(b)))


def _ola(y_f: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., frames, n_fft] -> [..., (frames - 1) hop + n_fft], summed in
    frame order."""
    frames, n_fft = y_f.shape[-2:]
    out = y_f.new_zeros((*y_f.shape[:-2], (frames - 1) * hop + n_fft))
    for j in range(frames):
        out[..., j * hop:j * hop + n_fft] += y_f[..., j, :]
    return out


def _shift_band(xb, semitones, geo, rnd: _Round):
    """One band's phase-vocoder shift of rows xb [R, Tb] -> [R, Tb]."""
    n_fft, hop, win = geo["n_fft"], geo["hop"], geo["win"]
    R, Tb = xb.shape
    dev = xb.device
    if Tb < n_fft:
        xb = F.pad(xb, (0, n_fft - Tb))
    window = _window(win, n_fft, dev)
    fwd, inv = _bases(n_fft, dev)
    F_ = n_fft // 2 + 1

    # the STFT: centred frames, windowed, times [cos | sin]
    xp = F.pad(xb, (n_fft // 2, n_fft // 2))
    frames = 1 + (xp.shape[-1] - n_fft) // hop
    framed = xp.unfold(-1, n_fft, hop)[:, :frames] * window
    both = _product(framed, fwd, rnd)                       # [R, frames, 2F]
    scale = float(1.0 / np.sqrt(n_fft))
    re = (both[..., :F_] * scale).transpose(1, 2)           # [R, F, frames]
    im = (-both[..., F_:] * scale).transpose(1, 2)
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
    a = tp - t0.float()
    om = _omega(F_, hop, n_fft, dev)[:, None]
    phi0, phi1 = phase[..., t0], phase[..., t1]
    mag_s = (1 - a) * mag[..., t0] + a * mag[..., t1]
    phi = phi0 + om + a * _princarg(phi1 - phi0 - om)
    rows = torch.cat([mag_s * torch.cos(phi), mag_s * torch.sin(phi)],
                     dim=1).transpose(1, 2)                # [R, fo, 2F]

    # the ISTFT: times the inverse basis, scaled, windowed, overlap-added
    # over the window's square, centred in (fo - 1) hop + n_fft
    y_f = _product(rows, inv, rnd) * float(np.sqrt(n_fft)) * window
    y = _ola(y_f, hop)
    wsq = _ola((window * window).expand(frames_out, n_fft), hop)
    y = y / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    lo, hi = n_fft // 2, n_fft // 2 + (frames_out - 1) * hop
    y = F.pad(y[:, lo:hi], (lo, y.shape[-1] - hi))
    return F.interpolate(y[:, None, :], size=Tb, mode="linear",
                         align_corners=False)[:, 0, :]


def shifted_bands(x: torch.Tensor, hk, shifts, geo: dict,
                  rounding: str = "tier") -> torch.Tensor:
    """Blocks x [R, T] -> every band shifted, before the crossfade:
    [R, M, T/M]."""
    rnd = _Round(rounding)
    sub = rnd.result(bank.analysis(rnd.operand(x), rnd.bank(hk)))
    return torch.stack([_shift_band(sub[:, m], shifts[m], geo, rnd)
                        for m in range(sub.shape[1])], dim=1)


def step(x: torch.Tensor, x_prev, hk, shifts, geo: dict,
         rounding: str = "tier") -> torch.Tensor:
    """The output [R, T] of blocks x [R, T] of R streams whose previous
    blocks were ``x_prev`` [R, T] (``None``: each stream's first block,
    whose carried tail is zero), at ``rounding``."""
    rnd = _Round(rounding)
    y = shifted_bands(x, hk, shifts, geo, rounding)
    L = geo["crossfade"]
    if L > 0:
        if x_prev is None:
            tail = torch.zeros_like(y[..., :L])
        else:
            tail = shifted_bands(x_prev, hk, shifts, geo,
                                 rounding)[..., -L:]
        fade = _window(2 * L, 2 * L, x.device)
        head = tail * fade[:L] + y[..., :L] * fade[L:]
        y = torch.cat([head, y[..., L:]], dim=-1)
    return rnd.result(bank.synthesis(rnd.operand(y), rnd.bank(hk)))
