"""Plain reference of the PQMF bank (acids-ircam RAVE ``pqmf.py``).

- :func:`design`: the Kaiser prototype whose cutoff Nelder-Mead tunes
  (``scipy.signal.kaiserord`` / ``firwin``, ``scipy.optimize.fmin``), then
  the cosine modulation into ``M`` bands, centre-padded to a power of two.
- :func:`analysis` / :func:`synthesis`: the cached (streaming) form the
  wrappers serve, one block at a time with centred padding: a strided
  ``1 -> M`` convolution of ``make_odd(hk)`` and the sign mask; the mask,
  an ``M -> M`` convolution of the time-flipped polyphase bank times ``M``,
  the band flip and the phase interleave.
- :func:`polyphase_roundtrip`: the offline polyphase analysis then
  synthesis (``PQMF.forward`` then ``PQMF.inverse``).

Float32 with TF32 off; ``tf32=True`` rounds every convolution's operands
to TF32 first (the control).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import optimize, signal

__all__ = ["design", "analysis", "synthesis", "polyphase_roundtrip",
           "to_tf32", "exact_f32"]


def kaiser_filter(wc: float, atten: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass of cutoff ``wc`` (rad/sample) with
    ``atten`` dB of stopband, at the smallest odd length that reaches it."""
    n, beta = signal.kaiserord(atten, wc / np.pi)
    n = 2 * (n // 2) + 1
    return signal.firwin(n, wc, window=("kaiser", beta), scale=False,
                         fs=2 * np.pi)


def _loss(wc: float, atten: float, M: int) -> float:
    """Lin & Vaidyanathan's distortion: the largest autocorrelation of the
    prototype at the nonzero multiples of 2M lags."""
    h = kaiser_filter(wc, atten)
    g = np.convolve(h, h[::-1], "full")
    return float(np.max(np.abs(g[g.shape[-1] // 2::2 * M][1:])))


@functools.lru_cache(maxsize=8)
def _design(atten: float, M: int) -> np.ndarray:
    wc = optimize.fmin(lambda w: _loss(float(w[0]), atten, M), 1.0 / M,
                       disp=0)[0]
    h = kaiser_filter(float(wc), atten).astype(np.float32)
    k = np.arange(M)[:, None]
    N = h.shape[-1]
    t = np.arange(-(N // 2), N // 2 + 1)
    hk = 2 * h * np.cos((2 * k + 1) * math.pi / (2 * M) * t
                        + (-1.0) ** k * math.pi / 4)
    P = 2 ** math.ceil(math.log2(N))
    pad = P - N
    hk = np.pad(hk, ((0, 0), (pad // 2, pad // 2 + pad % 2)))
    hk = hk.astype(np.float32)
    hk.setflags(write=False)
    return hk


def design(atten: float, M: int) -> np.ndarray:
    """The modulated bank ``hk`` [M, P], float32."""
    return _design(float(atten), int(M)).copy()


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    bits = a.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def exact_f32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (TF32 off),
    the previous settings restored on exit."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv1d(x, w, stride=1, padding=0, tf32=False):
    if tf32:
        x, w = to_tf32(x), to_tf32(w)
    with exact_f32():
        return F.conv1d(x, w, stride=stride, padding=padding)


def reverse_half(x: torch.Tensor) -> torch.Tensor:
    """Negate the even time samples of the odd bands of x [..., M, T]."""
    mask = torch.ones(x.shape[-2:], dtype=x.dtype, device=x.device)
    mask[1::2, ::2] = -1.0
    return x * mask


def _bank(hk, like: torch.Tensor) -> torch.Tensor:
    """The float32 bank in ``like``'s dtype, on its device."""
    return torch.as_tensor(np.asarray(hk, np.float32)).to(like.device,
                                                           like.dtype)


def _make_odd(w: torch.Tensor) -> torch.Tensor:
    return F.pad(w, (0, 1)) if w.shape[-1] % 2 == 0 else w


def _synthesis_bank(hk: torch.Tensor) -> torch.Tensor:
    """The time-flipped polyphase bank, ``c (t m) -> m c t``: [M, M, P/M]."""
    M, P = hk.shape
    return hk.flip(-1).reshape(M, P // M, M).permute(2, 0, 1).contiguous()


def analysis(x: torch.Tensor, hk, tf32: bool = False) -> torch.Tensor:
    """Cached analysis of blocks x [B, T] -> sub-bands [B, M, T/M]."""
    w = _make_odd(_bank(hk, x))[:, None, :]
    M, K = w.shape[0], w.shape[-1]
    y = conv1d(x[:, None, :], w, stride=M, padding=(K - 1) // 2, tf32=tf32)
    return reverse_half(y)


def synthesis(sub: torch.Tensor, hk, tf32: bool = False) -> torch.Tensor:
    """Cached synthesis of sub-bands [B, M, T'] -> blocks [B, T'*M]."""
    w = _make_odd(_synthesis_bank(_bank(hk, sub)))
    M, K = w.shape[0], w.shape[-1]
    y = conv1d(reverse_half(sub), w, padding=(K - 1) // 2, tf32=tf32) * M
    y = y.flip(1)
    return y.transpose(1, 2).reshape(sub.shape[0], -1)


def polyphase_roundtrip(x: torch.Tensor, hk, tf32: bool = False):
    """Offline polyphase analysis then synthesis of x [B, T] -> [B, T]."""
    hk = _bank(hk, x)
    M, P = hk.shape
    L = P // M
    B, T = x.shape
    xp = x.reshape(B, T // M, M).transpose(1, 2)          # b (t m) -> b m t
    hp = hk.reshape(M, L, M).permute(0, 2, 1).contiguous()  # c (t m) -> c m t
    sub = reverse_half(conv1d(xp, hp, padding=L // 2, tf32=tf32)[..., :-1])
    y = conv1d(reverse_half(sub), _synthesis_bank(hk), padding=L // 2 + 1,
               tf32=tf32)[..., :-1] * M
    y = y.flip(1).transpose(1, 2).reshape(B, -1)           # b m t -> b (t m)
    return y[:, 2 * M:]
