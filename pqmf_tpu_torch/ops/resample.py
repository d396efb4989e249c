"""Resampling of the pitch shifters.

PyTorch counterpart of ``pqmf_tpu/ops/resample.py``:

1. linear interpolation, ``F.interpolate(mode='linear',
   align_corners=False)`` — :func:`interpolate_linear` (static length, the
   standalone shifters) and :func:`interpolate_linear_dynamic` (a valid
   prefix per row, the flagship's stretched bands), both as plain gathers
   (the JAX package's one-hot, chunked and prefolded forms exist only for
   the TPU);
2. the windowed-sinc polyphase resampler of
   ``torchaudio.functional.resample`` — :func:`sinc_resample`, and its
   row-sparse plan :func:`banded_resample_plan` for the torchaudio-variant
   wrapper. The kernel bank and the plan are the JAX package's host-side
   NumPy, copied, so both are bit-equal to JAX's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.ops.filterbank import full_f32

__all__ = [
    "interpolate_linear",
    "interpolate_linear_dynamic",
    "sinc_resample_kernel",
    "sinc_resample",
    "banded_resample_plan",
]


def interpolate_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """``F.interpolate(x, size, mode='linear', align_corners=False)``.

    x: [..., T] -> [..., size]. Source coordinate of output i is
    ``(i + 0.5) * T/size - 0.5`` clamped to [0, T-1]."""
    T = x.shape[-1]
    scale = float(np.float32(T / size))
    src = (torch.arange(size, dtype=torch.float32, device=x.device)
           + 0.5) * scale - 0.5
    src = src.clamp(0.0, T - 1)
    i0 = torch.floor(src).to(torch.int64)
    i1 = (i0 + 1).clamp_max(T - 1)
    a = (src - i0.to(torch.float32)).to(x.dtype)
    return x[..., i0] * (1 - a) + x[..., i1] * a


def interpolate_linear_dynamic(x: torch.Tensor, src_len: torch.Tensor,
                               size: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=False)`` of the valid
    prefix ``x[..., :src_len]`` to ``size`` samples.

    x: [..., T]; src_len: int tensor broadcastable to ``x.shape[:-1]`` (one
    length per row of a padded buffer). Returns [..., size]. Source
    coordinate of output i: ``(i + 0.5) * src_len/size - 0.5`` clamped to
    [0, src_len - 1].

    Agrees with the JAX one-hot matmul form to the last bit except where
    the clamp makes i0 == i1 (the last output sample of some lengths):
    there the one-hot form sums the weights first, ``((1-a)+a)*x`` against
    ``x*(1-a) + x*a`` here, which can differ by one ulp."""
    T = x.shape[-1]
    sl = src_len.unsqueeze(-1)
    slf = sl.to(torch.float32)
    pos = torch.arange(size, dtype=torch.float32, device=x.device)
    src = (pos + 0.5) * (slf / size) - 0.5
    src = torch.minimum(src.clamp_min(0.0), (slf - 1).clamp_min(0.0))
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.minimum(i0 + 1, (sl - 1).clamp_min(0))
    i0 = i0.clamp(0, T - 1)
    i1 = i1.clamp(0, T - 1)
    a = (src - i0.to(torch.float32)).to(x.dtype)
    shape = (*x.shape[:-1], size)
    x0 = torch.gather(x, -1, i0.expand(shape))
    x1 = torch.gather(x, -1, i1.expand(shape))
    return x0 * (1 - a) + x1 * a


# torchaudio.functional.resample's defaults, the setting the shifters use:
# a Hann-windowed sinc of 6 zero crossings, cut off at 0.99 of the lower
# Nyquist
LOWPASS_FILTER_WIDTH = 6
ROLLOFF = 0.99
KAISER_BETA = 14.769656459379492  # torchaudio's default beta


def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = LOWPASS_FILTER_WIDTH,
                         rolloff: float = ROLLOFF,
                         window: str = "hann",
                         beta: float | None = None,
                         dtype=np.float32):
    """The polyphase windowed-sinc kernel bank (host-side NumPy), following
    the torchaudio/resampy construction: one FIR per output phase at the
    reduced ratio ``new/orig``, of ``lowpass_filter_width`` zero crossings
    cut off at ``rolloff`` of the lower Nyquist, under the ``"hann"`` or
    the ``"kaiser"`` window (``beta``, by default torchaudio's), in NumPy
    ``dtype``.

    Returns (kernels [new, 1, K], width, orig, new) with the reduced rates;
    width is the one-sided support in input samples."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_freq, new_freq = int(orig_freq) // g, int(new_freq) // g

    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx[None]
         ) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    if window == "hann":
        win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    elif window == "kaiser":
        if beta is None:
            beta = KAISER_BETA
        win = np.i0(beta * np.sqrt(np.clip(
            1 - (t / lowpass_filter_width) ** 2, 0, 1))) / np.i0(beta)
    else:
        raise ValueError(f"unknown window {window}")

    scale = base_freq / orig_freq
    with np.errstate(invalid="ignore", divide="ignore"):
        kernels = np.where(t == 0, 1.0, np.sin(np.pi * t) / (np.pi * t))
    kernels = (kernels * win * scale).astype(dtype)
    return kernels[:, None, :], width, orig_freq, new_freq


def banded_resample_plan(orig_freq: int, new_freq: int, n_out: int,
                         lowpass_filter_width: int = LOWPASS_FILTER_WIDTH,
                         rolloff: float = ROLLOFF, window: str = "hann"):
    """Row-sparse (banded) form of :func:`sinc_resample` for a fixed output
    length (host-side NumPy, one-time per plan).

    Each output sample reads only the ~``2*width+1`` input taps under its
    sinc support, so the resample is ``z[j] = sum_k W[j, k] * y[start[j] +
    k]`` — a gather and a short weighted sum that batches across sub-bands
    with *different* ratios (each band pads its rows to a common tap
    count).

    Returns ``(W [n_out, K_taps], start [n_out] int32, width)`` with
    ``start`` in *unpadded* input coordinates (down to ``-width``; callers
    left-pad the input by >= width and offset). Row ``j`` reproduces
    ``sinc_resample(y, orig, new)[..., j]`` for any input length T with
    ``j < ceil(T * new/orig)``; callers zero the rows past it."""
    if orig_freq == new_freq:
        # identity plan, mirroring torchaudio's equal-rate short-circuit
        return (np.ones((n_out, 1), np.float32),
                np.arange(n_out, dtype=np.int32), 0)
    kernels, width, o, n = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff, window)
    kern = kernels[:, 0, :]  # [n, K], K = 2*width + o

    # per used phase: nonzero span (the sinc support; outside it the Hann
    # window's taps are exactly zero, the Kaiser window's tiny but not
    # zero, so its span is wider: no threshold, as in the JAX package)
    used = sorted({j % n for j in range(n_out)})
    spans = {}
    for p in used:
        nz = np.flatnonzero(kern[p] != 0.0)
        spans[p] = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1)
    K_taps = max(hi - lo for lo, hi in spans.values())

    W = np.zeros((n_out, K_taps), kern.dtype)
    start = np.zeros((n_out,), np.int32)
    for j in range(n_out):
        s, p = divmod(j, n)
        lo, hi = spans[p]
        W[j, : hi - lo] = kern[p, lo:hi]
        start[j] = s * o - width + lo
    return W, start, width


@functools.lru_cache(maxsize=16)
def _sinc_bank(orig_freq: int, new_freq: int, lowpass_filter_width: int,
               rolloff: float, window: str, device):
    """The kernel bank of :func:`sinc_resample_kernel` as a [new, K] f32
    tensor on ``device`` with (width, orig, new): built once per ratio and
    filter, since a large reduced ratio makes a bank of tens of MB."""
    kernels, width, o, n = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff, window)
    return torch.as_tensor(kernels[:, 0, :], device=device), width, o, n


def sinc_resample(x: torch.Tensor, orig_freq: int, new_freq: int,
                  lowpass_filter_width: int = LOWPASS_FILTER_WIDTH,
                  rolloff: float = ROLLOFF,
                  window: str = "hann") -> torch.Tensor:
    """Windowed-sinc polyphase resample, torchaudio-style, with the filter
    of :func:`sinc_resample_kernel`.

    x: [B, T] -> [B, ceil(T * new/orig)]; equal rates return x (torchaudio
    short-circuits them before any filtering)."""
    if orig_freq == new_freq:
        return x
    kern, width, o, _ = _sinc_bank(int(orig_freq), int(new_freq),
                                   int(lowpass_filter_width), float(rolloff),
                                   window, x.device)
    B, T = x.shape
    target_len = int(math.ceil(new_freq * T / orig_freq))
    # one frame of K input taps per conv step (one step per `new` output
    # samples), then one matmul against all the phases
    xp = F.pad(x, (width, width + o))
    steps = -(-T // o)
    frames = xp.unfold(-1, kern.shape[-1], o)[:, :steps]  # [B, S, K]
    with full_f32():
        y = torch.matmul(frames, kern.t())  # [B, S, new]
    # output sample s*new + p comes from phase p at step s
    return y.reshape(B, -1)[:, :target_len]
