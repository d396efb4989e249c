"""torch.stft-compatible real-valued STFT / ISTFT as matmuls.

PyTorch counterpart of ``pqmf_tpu/ops/stft.py``: center padding of
``n_fft//2`` (zeros, or the reflection the torchaudio-variant shifter
uses), a ``win_length`` Hann window zero-padded centered to ``n_fft``,
frame count ``1 + (T_padded - n_fft) // hop``, ``normalized=True``
scaling, and overlap-add with the window-square sum and torch.istft's
``length`` semantics.

The DFT of the serving paths (``stft_ri`` / ``istft_ri``) is a matmul
against a cos/sin basis, not ``torch.fft``: on an exactly-zero frame the
matmul gives +0.0 real parts (phase 0) where an FFT gives -0.0 (phase pi),
and the pitch shifters' stretch reads that phase. The matmuls run in full
f32 (:func:`~pqmf_tpu_torch.ops.filterbank.full_f32`); at the ``"default"``
precision tier both operands are rounded to bf16 first (:func:`dft_matmul`),
the TPU's one bf16 pass with f32 sums, on every device. The complex
:func:`stft` / :func:`istft` on ``torch.fft`` are kept for parity checks,
as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.ops.filterbank import check_precision, full_f32

__all__ = [
    "hann_window",
    "reflect_pad",
    "frame_count",
    "dft_matmul",
    "dft_basis",
    "idft_basis",
    "stft",
    "istft",
    "stft_ri",
    "ta_stft_ri",
    "istft_ri",
    "istft_ri_parts",
]


def float_dtype(dtype) -> torch.dtype:
    """``dtype`` — a ``torch.dtype`` or a NumPy float dtype, the JAX
    package's ``dtype`` argument — as a floating ``torch.dtype``. A device
    in its place raises ``TypeError``: the tables below take the device as
    the keyword ``device``."""
    if isinstance(dtype, torch.dtype):
        t = dtype
    elif isinstance(dtype, torch.device):
        t = None
    else:
        try:
            t = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        except TypeError:
            t = None
    if t is None or not t.is_floating_point:
        raise TypeError(f"dtype must be a float dtype, got {dtype!r} (pass "
                        "the device as device=)")
    return t


def _on(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A float64 NumPy table rounded once to ``dtype``, then on ``device``."""
    return torch.as_tensor(a).to(float_dtype(dtype)).to(device)


@functools.lru_cache(maxsize=32)
def hann_window(win_length: int, dtype=torch.float32, *,
                device="cpu") -> torch.Tensor:
    """torch.hann_window (periodic=True): 0.5 - 0.5 cos(2 pi n / N),
    evaluated in float64 and rounded once to ``dtype``. Cached per
    (length, dtype, device), like the DFT bases: callers must not write to
    it."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return _on(w, dtype, device)


def _padded_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Zero-pad a win_length window centered to n_fft (torch semantics)."""
    wl = window.shape[-1]
    if wl == n_fft:
        return window
    left = (n_fft - wl) // 2
    return F.pad(window, (left, n_fft - wl - left))


def frame_count(T: int, n_fft: int, hop_length: int,
                center: bool = True) -> int:
    """Frames of an STFT of T samples, centered (padded by n_fft//2 each
    side) or not."""
    if center:
        T = T + 2 * (n_fft // 2)
    return 1 + (T - n_fft) // hop_length


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``jnp.pad(x, mode="reflect")`` on the last axis, for any pad width.

    ``F.pad(mode="reflect")`` raises once a pad reaches the input's length;
    NumPy and JAX keep reflecting, which is the periodic even extension of
    period ``2 (T - 1)`` (a 1-sample input repeats). The torchaudio-variant
    shifter pads sub-bands by ``n_fft//2`` = 256, as long as the 8-band
    bands of a 2048 block, so it needs that extension."""
    T = x.shape[-1]
    i = torch.arange(-left, T + right, device=x.device)
    if T == 1:
        idx = torch.zeros_like(i)
    else:
        period = 2 * (T - 1)
        j = torch.remainder(i, period)
        idx = torch.where(j >= T, period - j, j)
    return x.index_select(-1, idx)


def _center_pad(x: torch.Tensor, n_fft: int,
                pad_mode: str = "constant") -> torch.Tensor:
    """torch.stft's center padding of x [B, T]: n_fft//2 each side, zeros
    (``"constant"``) or the reflection (``"reflect"``, as JAX pads)."""
    pad = n_fft // 2
    if pad_mode == "constant":
        return F.pad(x, (pad, pad))
    if pad_mode == "reflect":
        return reflect_pad(x, pad, pad)
    raise ValueError(f"unsupported pad_mode {pad_mode}")


def _trim_or_pad(out: torch.Tensor, total: int, center: bool,
                 length: int | None, n_fft: int) -> torch.Tensor:
    """torch.istft's length semantics: center-trim by n_fft//2; with an
    explicit ``length`` the OLA samples after the trim come first, then
    zeros."""
    if center:
        trim = n_fft // 2
        if length is None:
            return out[..., trim: total - trim]
        avail = min(length, total - trim)
        out = out[..., trim: trim + avail]
    elif length is None:
        return out
    else:
        avail = min(length, total)
        out = out[..., :avail]
    if avail < length:
        out = F.pad(out, (0, length - avail))
    return out


def dft_matmul(a: torch.Tensor, b: torch.Tensor,
               precision: str = "highest") -> torch.Tensor:
    """``a @ b`` of a DFT at a precision tier (JAX's ``einsum_precision``,
    ``pqmf_tpu/ops/stft.py:261``): at ``"default"`` both operands are
    rounded to bf16 (nearest even) and the product runs in full f32, the
    TPU's one bf16 pass with f32 sums; ``"highest"`` and ``"bf16x3"`` run
    it in full f32 (the JAX package's bf16x3 changes only its conv
    kernels)."""
    if check_precision(precision) == "default":
        a = a.to(torch.bfloat16).to(a.dtype)
        b = b.to(torch.bfloat16).to(b.dtype)
    with full_f32():
        return torch.matmul(a, b)


@functools.lru_cache(maxsize=32)
def _dft_basis_np(n_fft: int):
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft  # [n_fft, F]
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=32)
def dft_basis(n_fft: int, dtype=torch.float32, *, device="cpu"):
    """rfft as matmul: re = frames @ C, im = frames @ (-S).

    Returns (C [n_fft, F], S [n_fft, F]) in ``dtype`` (built in float64,
    rounded once) with F = n_fft//2 + 1."""
    c, s = _dft_basis_np(n_fft)
    return _on(c, dtype, device), _on(s, dtype, device)


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
def idft_basis(n_fft: int, dtype=torch.float32, *, device="cpu"):
    """irfft as matmul: x = re @ Ci + im @ Si (hermitian-symmetric
    weights folded in), in ``dtype`` (built in float64, rounded once)."""
    ci, si = _idft_basis_np(n_fft)
    return _on(ci, dtype, device), _on(si, dtype, device)


def _frame_signal(x: torch.Tensor, n_fft: int, hop: int, frames: int):
    """[..., Tp] -> [..., frames, n_fft] sliding windows (a copy-free
    view)."""
    need = (frames - 1) * hop + n_fft
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, n_fft, hop)[..., :frames, :]


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


def _framed(x, n_fft, hop_length, window, center, pad_mode):
    """Center-pad, frame and window x [B, T] -> [B, frames, n_fft]."""
    if center:
        x = _center_pad(x, n_fft, pad_mode)
    frames = 1 + (x.shape[-1] - n_fft) // hop_length
    w = _padded_window(window, n_fft).to(x.dtype)
    return _frame_signal(x, n_fft, hop_length, frames) * w


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
         center: bool = True, normalized: bool = True,
         pad_mode: str = "constant") -> torch.Tensor:
    """Complex STFT matching ``torch.stft`` on ``torch.fft.rfft``.

    x: [B, T] -> complex64 [B, n_fft//2 + 1, frames]."""
    spec = torch.fft.rfft(
        _framed(x, n_fft, hop_length, window, center, pad_mode), dim=-1)
    if normalized:
        spec = spec * float(1.0 / np.sqrt(n_fft))
    return spec.transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          window: torch.Tensor, center: bool = True, normalized: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`stft` matching ``torch.istft``: complex
    [B, F, frames] -> [B, length], by default ``(frames-1)*hop``."""
    frames = spec.shape[-1]
    w = _padded_window(window, n_fft)
    y_f = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)
    if normalized:
        y_f = y_f * float(np.sqrt(n_fft))
    y = _ola(y_f * w, n_fft, hop_length)
    wsq = _ola((w * w).expand(frames, n_fft), n_fft, hop_length)
    out = y / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    return _trim_or_pad(out, y.shape[-1], center, length, n_fft)


def stft_ri(x: torch.Tensor, n_fft: int, hop_length: int,
            window: torch.Tensor, center: bool = True,
            normalized: bool = True, pad_mode: str = "constant",
            precision: str = "highest"):
    """:func:`stft` with real/imag outputs via a matmul DFT at
    ``precision`` (:func:`dft_matmul`).

    x: [B, T] -> (re, im) each [B, F, frames], in x's dtype (float32, or
    float64 over the same float32 basis)."""
    framed = _framed(x, n_fft, hop_length, window, center, pad_mode)
    C, S = dft_basis(n_fft, device=x.device)
    # one matmul for both parts: each output column is its own dot
    both = dft_matmul(framed, torch.cat([C, S], dim=1).to(x.dtype),
                      precision)
    both = both.transpose(1, 2)  # [B, 2F, frames]
    F_ = n_fft // 2 + 1
    re, im = both[:, :F_], -both[:, F_:]
    if normalized:
        scale = float(1.0 / np.sqrt(n_fft))
        re, im = re * scale, im * scale
    return re, im


def ta_stft_ri(x: torch.Tensor, n_fft: int, hop_length: int,
               window: torch.Tensor, precision: str = "highest"):
    """The torchaudio variant's analysis: :func:`stft_ri` of x [B, T] with
    the reflect pad and no normalization, summed in float64 and rounded
    once to float32.

    The running phase reads every bin's angle, and in a near-zero bin a
    float32 summation-order difference (the card's GEMM against the CPU's)
    turns it by up to radians, which the phase sum carries into every
    later frame (with a float32 DFT, the standalone shifter on 10 s at
    2756 Hz measured 90.9 dB on an NVIDIA H100 against the CPU). The
    standalone :class:`~pqmf_tpu_torch.shifters.TorchaudioPitchShift`
    and the fused per-band path of the wrapper share this one analysis. At
    the ``"default"`` tier its operands are rounded to bf16 first, as
    :func:`dft_matmul` rounds them."""
    re, im = stft_ri(x.double(), n_fft, hop_length, window, center=True,
                     normalized=False, pad_mode="reflect",
                     precision=precision)
    return re.float(), im.float()


def istft_ri_parts(re, im, n_fft: int, hop_length: int, window,
                   normalized: bool = True, frame_mask=None,
                   precision: str = "highest"):
    """OLA core of the real-valued ISTFT: returns (y, wsq) over the full
    padded length ``n_fft + (frames-1)*hop``.

    re/im: [..., F, frames]. ``frame_mask`` [..., frames] of 0/1 (leading
    dims broadcast against re's) drops frames from both sums — the pitch
    shifters' per-band ``frames_out``. The IDFT runs at ``precision``
    (:func:`dft_matmul`)."""
    frames = re.shape[-1]
    w = _padded_window(window, n_fft)
    Ci, Si = idft_basis(n_fft, device=re.device)
    ri = torch.cat([re, im], dim=-2).transpose(-1, -2)  # [..., frames, 2F]
    y_f = dft_matmul(ri, torch.cat([Ci, Si], dim=0), precision)
    if normalized:
        y_f = y_f * float(np.sqrt(n_fft))
    y_f = y_f * w

    wsq_f = (w * w).expand(frames, n_fft)
    if frame_mask is not None:
        y_f = y_f * frame_mask[..., :, None]
        wsq_f = wsq_f * frame_mask[..., :, None]

    return _ola(y_f, n_fft, hop_length), _ola(wsq_f, n_fft, hop_length)


def istft_ri(re: torch.Tensor, im: torch.Tensor, n_fft: int,
             hop_length: int, window: torch.Tensor, center: bool = True,
             normalized: bool = True, length: int | None = None,
             precision: str = "highest"):
    """:func:`istft` from real/imag spectra via the matmul IDFT:
    [B, F, frames] each -> [B, length]."""
    y, wsq = istft_ri_parts(re, im, n_fft, hop_length, window,
                            normalized=normalized, precision=precision)
    out = y / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    return _trim_or_pad(out, y.shape[-1], center, length, n_fft)
