"""torch.stft-compatible real-valued STFT / ISTFT as matmuls.

PyTorch counterpart of the real-valued path of ``pqmf_tpu/ops/stft.py``
(``stft_ri`` / ``istft_ri_parts``): center padding of ``n_fft//2``, a
``win_length`` Hann window zero-padded centered to ``n_fft``, frame count
``1 + (T_padded - n_fft) // hop``, ``normalized=True`` scaling, and
overlap-add with the window-square sum.

The DFT is a matmul against a cos/sin basis, not ``torch.fft``: on an
exactly-zero frame the matmul gives +0.0 real parts (phase 0) where an FFT
gives -0.0 (phase pi), and the pitch shifter's stretch reads that phase.
The matmuls run in full f32 (:func:`~pqmf_tpu_torch.ops.filterbank.full_f32`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.ops.filterbank import full_f32

__all__ = [
    "hann_window",
    "frame_count",
    "dft_basis",
    "idft_basis",
    "stft_ri",
    "istft_ri_parts",
]


@functools.lru_cache(maxsize=32)
def hann_window(win_length: int, device="cpu") -> torch.Tensor:
    """torch.hann_window (periodic=True): 0.5 - 0.5 cos(2 pi n / N),
    evaluated in float64 and rounded once to float32. Cached per
    (length, device), like the DFT bases: callers must not write to it."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.as_tensor(w.astype(np.float32), device=device)


def _padded_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Zero-pad a win_length window centered to n_fft (torch semantics)."""
    wl = window.shape[-1]
    if wl == n_fft:
        return window
    left = (n_fft - wl) // 2
    return F.pad(window, (left, n_fft - wl - left))


def frame_count(T: int, n_fft: int, hop_length: int) -> int:
    """Frames of a centered STFT of T samples."""
    return 1 + (T + 2 * (n_fft // 2) - n_fft) // hop_length


def _center_pad(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """torch.stft's center padding of x [B, T]: n_fft//2 zeros each side
    (``pad_mode="constant"``, the only mode the flagship uses)."""
    return F.pad(x, (n_fft // 2, n_fft // 2))


@functools.lru_cache(maxsize=32)
def _dft_basis_np(n_fft: int):
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft  # [n_fft, F]
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=32)
def dft_basis(n_fft: int, device="cpu"):
    """rfft as matmul: re = frames @ C, im = frames @ (-S).

    Returns (C [n_fft, F], S [n_fft, F]) float32 with F = n_fft//2 + 1."""
    c, s = _dft_basis_np(n_fft)
    return (torch.as_tensor(c.astype(np.float32), device=device),
            torch.as_tensor(s.astype(np.float32), device=device))


@functools.lru_cache(maxsize=32)
def _idft_basis_np(n_fft: int):
    F_ = n_fft // 2 + 1
    k = np.arange(F_)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft  # [F, n_fft]
    w = np.full(F_, 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    ci = w[:, None] * np.cos(ang)
    si = -w[:, None] * np.sin(ang)
    return ci, si


@functools.lru_cache(maxsize=32)
def idft_basis(n_fft: int, device="cpu"):
    """irfft as matmul: x = re @ Ci + im @ Si (hermitian-symmetric
    weights folded in)."""
    ci, si = _idft_basis_np(n_fft)
    return (torch.as_tensor(ci.astype(np.float32), device=device),
            torch.as_tensor(si.astype(np.float32), device=device))


def _frame_signal(x: torch.Tensor, n_fft: int, hop: int, frames: int):
    """[B, Tp] -> [B, frames, n_fft] sliding windows (a copy-free view)."""
    need = (frames - 1) * hop + n_fft
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, n_fft, hop)[:, :frames]


def _ola(y_f: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., frames, n_fft] -> [..., n_fft + (frames-1)*hop] overlap-add.

    When hop divides n_fft the frames are added in ``ratio`` shifted
    passes, in the JAX package's order; otherwise one index_add."""
    frames = y_f.shape[-2]
    lead = y_f.shape[:-2]
    if n_fft % hop == 0:
        ratio = n_fft // hop
        rows = frames + ratio - 1
        yc = y_f.reshape(*lead, frames, ratio, hop)
        acc = torch.zeros((*lead, rows, hop), dtype=y_f.dtype,
                          device=y_f.device)
        for j in range(ratio):
            acc[..., j:j + frames, :] += yc[..., :, j, :]
        return acc.reshape(*lead, rows * hop)
    total = n_fft + (frames - 1) * hop
    idx = (torch.arange(frames, device=y_f.device)[:, None] * hop
           + torch.arange(n_fft, device=y_f.device)[None, :]).reshape(-1)
    out = torch.zeros((*lead, total), dtype=y_f.dtype, device=y_f.device)
    return out.index_add_(-1, idx, y_f.reshape(*lead, frames * n_fft))


def stft_ri(x: torch.Tensor, n_fft: int, hop_length: int,
            window: torch.Tensor, normalized: bool = True):
    """torch.stft (``center=True, pad_mode="constant"``) with real/imag
    outputs via a matmul DFT.

    x: [B, T] -> (re, im) each [B, F, frames]."""
    x = _center_pad(x, n_fft)
    frames = 1 + (x.shape[-1] - n_fft) // hop_length
    w = _padded_window(window, n_fft).to(x.dtype)
    framed = _frame_signal(x, n_fft, hop_length, frames) * w
    C, S = dft_basis(n_fft, x.device)
    with full_f32():
        # one matmul for both parts: each output column is its own dot
        both = torch.matmul(framed, torch.cat([C, S], dim=1))
    both = both.transpose(1, 2)  # [B, 2F, frames]
    F_ = n_fft // 2 + 1
    re, im = both[:, :F_], -both[:, F_:]
    if normalized:
        scale = float(1.0 / np.sqrt(n_fft))
        re, im = re * scale, im * scale
    return re, im


def istft_ri_parts(re, im, n_fft: int, hop_length: int, window,
                   normalized: bool = True, frame_mask=None):
    """OLA core of the real-valued ISTFT: returns (y, wsq) over the full
    padded length ``n_fft + (frames-1)*hop``.

    re/im: [..., F, frames]. ``frame_mask`` [..., frames] of 0/1 (leading
    dims broadcast against re's) drops frames from both sums — the pitch
    shifter's per-band ``frames_out``."""
    frames = re.shape[-1]
    w = _padded_window(window, n_fft)
    Ci, Si = idft_basis(n_fft, re.device)
    ri = torch.cat([re, im], dim=-2).transpose(-1, -2)  # [..., frames, 2F]
    with full_f32():
        y_f = torch.matmul(ri, torch.cat([Ci, Si], dim=0))
    if normalized:
        y_f = y_f * float(np.sqrt(n_fft))
    y_f = y_f * w

    wsq_f = (w * w).expand(frames, n_fft)
    if frame_mask is not None:
        y_f = y_f * frame_mask[..., :, None]
        wsq_f = wsq_f * frame_mask[..., :, None]

    return _ola(y_f, n_fft, hop_length), _ola(wsq_f, n_fft, hop_length)
