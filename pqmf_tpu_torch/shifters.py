"""L3a — the standalone pitch shifters.

PyTorch counterpart of ``pqmf_tpu/shifters.py``, mirroring the reference's
API surface:

- :class:`PhaseVocoderPitchShift` — the reference's
  ``PhaseVocoderPitchShift`` (VocoderPitchShifter.py:50-306): STFT
  (normalized, centered, zero pad) -> the per-frame-independent stretch
  rule -> ISTFT (with the reference's 1-frame irfft fallback) -> center
  pad/crop to ``(frames_out-1)*hop + n_fft`` -> linear resample to the
  input length; ``accumulate_phase=True`` switches to the running phase;
- :class:`ResamplePitchShift` — ``ScriptablePitchShift``
  (1-PitchShifterWrapper.py:44-100): linear-resample speed change, center
  crop/pad;
- :class:`TorchaudioPitchShift` — ``torchaudio.transforms.PitchShift``
  (used per band in PQMFPsWrapper.py:68-72): reflect-pad STFT,
  accumulating phase vocoder, ISTFT to ``round(T/rate)``, windowed-sinc
  resample back, right crop/pad to T;
- :class:`PitchShifter` — a fixed-shift adapter over the first.

They are plain functions of their input tensor and run on its device (the
DFTs are matmuls, so no FFT is needed); NumPy input is taken as a CPU
tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.ops import phase_vocoder as pv
from pqmf_tpu_torch.ops import resample as rs
from pqmf_tpu_torch.ops import stft as S
from pqmf_tpu_torch.ops.filterbank import full_f32

__all__ = [
    "PhaseVocoderPitchShift",
    "PitchShifter",
    "ResamplePitchShift",
    "TorchaudioPitchShift",
]


def _norm_bt(x):
    """Accept [T], [B,T] or [B,1,T] -> ([B,T], restore_mode); a [B,1,T]
    conv buffer comes back [B,1,T] from :func:`_restore_bt`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    if x.ndim == 1:
        return x[None], "t"
    if x.ndim == 3 and x.shape[1] == 1:
        return x[:, 0], "b1t"
    if x.ndim != 2:
        raise ValueError("input must be [T], [B,T] or [B,1,T]")
    return x, "bt"


def _restore_bt(y, mode):
    """Undo :func:`_norm_bt`'s shape normalization."""
    if mode == "t":
        return y[0]
    if mode == "b1t":
        return y[:, None, :]
    return y


def _center_fit(y: torch.Tensor, length: int) -> torch.Tensor:
    """Center-crop or center zero-pad the last axis to ``length``."""
    cur = y.shape[-1]
    if cur > length:
        start = (cur - length) // 2
        return y[..., start:start + length]
    if cur < length:
        pad = length - cur
        return F.pad(y, (pad // 2, pad - pad // 2))
    return y


def _pvoc_shift_core(x, rate, n_fft, hop, win_length, T, frames_out,
                     accumulate=False):
    """The phase-vocoder shift of x [B, T_in >= n_fft] (already
    right-padded) for one geometry; returns [B, T]."""
    dev = x.device
    window = S.hann_window(win_length, dev)
    re, im = S.stft_ri(x, n_fft, hop, window, center=True, normalized=True,
                       pad_mode="constant")
    # f32-stepwise omega: bit-parity with the reference's construction at
    # the stretch's ±pi wrap boundaries (see phase_advance_reference)
    omega = pv.phase_advance_reference(re.shape[1], hop, n_fft, dev)
    if accumulate:
        re_s, im_s = pv.stretch_accumulate(re, im, rate, omega, frames_out)
    else:
        # reference magphase: sqrt(r^2 + i^2 + 1e-12) (:166)
        mag = torch.sqrt(re * re + im * im + 1e-12)
        phase = torch.atan2(im, re)
        mag_s, phi_s = pv.stretch_reference(mag, phase, rate, omega,
                                            frames_out)
        re_s, im_s = mag_s * torch.cos(phi_s), mag_s * torch.sin(phi_s)

    if frames_out == 1:
        # reference 1-frame fallback: direct irfft cropped to win_length
        # (VocoderTPitchShifter.py:127-138); it does NOT undo the
        # normalized analysis scaling — reproduced as it is
        Ci, Si = S.idft_basis(n_fft, dev)
        with full_f32():
            y = re_s[..., 0] @ Ci + im_s[..., 0] @ Si
        y = y[..., :win_length]
    else:
        y = S.istft_ri(re_s, im_s, n_fft, hop, window, center=True,
                       normalized=True)
    # center pad / truncate to the stretch length (:287-297), then the
    # linear resample back to the original length
    y = _center_fit(y, max(1, (frames_out - 1) * hop + n_fft))
    return rs.interpolate_linear(y, T)


class PhaseVocoderPitchShift:
    """Reference-exact phase-vocoder pitch shifter.

    Call with ``x: [T] | [B,T] | [B,1,T]`` and integer ``n_steps``
    (semitones); returns the same leading shape with length preserved.
    """

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, accumulate_phase: bool = False):
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self.win_length = int(win_length)
        self.accumulate_phase = accumulate_phase

    def geometry(self, T: int, n_steps: int):
        """Shape plan for (input length, shift): returns
        (T_padded, frames, frames_out, rate)."""
        Tp = max(T, self.n_fft)
        frames = S.frame_count(Tp, self.n_fft, self.hop_length)
        rate = 1.0 / 2.0 ** (float(int(n_steps)) / 12.0)
        frames_out = max(1, int(math.floor(frames / rate)))
        return Tp, frames, frames_out, rate

    def __call__(self, x, n_steps: int):
        x, mode = _norm_bt(x)
        T = x.shape[-1]
        Tp, _, frames_out, rate = self.geometry(T, n_steps)
        if Tp > T:
            x = F.pad(x, (0, Tp - T))
        y = _pvoc_shift_core(x, rate, self.n_fft, self.hop_length,
                             self.win_length, T, frames_out,
                             accumulate=self.accumulate_phase)
        return _restore_bt(y, mode)

    forward = __call__


class ResamplePitchShift:
    """``ScriptablePitchShift`` equivalent: speed change by linear
    interpolation to ``round(T/factor)``, then center crop/zero-pad back to
    T (1-PitchShifterWrapper.py:59-100)."""

    def __init__(self, n_steps: int):
        self.n_steps = int(n_steps)
        self.factor = float(2 ** (self.n_steps / 12.0))

    def __call__(self, x):
        x, mode = _norm_bt(x)
        T = x.shape[-1]
        new_len = max(1, int(round(float(T) / self.factor)))
        y = _center_fit(rs.interpolate_linear(x, new_len), T)
        return _restore_bt(y, mode)

    forward = __call__


def _ta_shift_core(x, rate, n_fft, hop, win_length, T, frames_out,
                   len_stretch, orig_freq, new_freq):
    """torchaudio's ``pitch_shift`` of x [B, T]: reflect-pad STFT
    (unnormalized), running-phase stretch, ISTFT to ``len_stretch``, sinc
    resample ``orig -> new``, right crop / right zero-pad to T."""
    dev = x.device
    window = S.hann_window(win_length, dev)
    re, im = S.ta_stft_ri(x, n_fft, hop, window)
    omega = pv.phase_advance(re.shape[1], hop, n_fft, dev)
    re_s, im_s = pv.stretch_accumulate(re, im, rate, omega, frames_out)
    y = S.istft_ri(re_s, im_s, n_fft, hop, window, center=True,
                   normalized=False, length=len_stretch)
    y = rs.sinc_resample(y, orig_freq, new_freq)
    cur = y.shape[-1]
    if cur >= T:
        return y[:, :T]
    return F.pad(y, (0, T - cur))


class TorchaudioPitchShift:
    """``torchaudio.transforms.PitchShift`` equivalent.

    rate = 2^(-n_steps/bins_per_octave); phase-vocoder time stretch by
    ``rate`` (accumulating phase), ISTFT to ``round(T/rate)``, sinc
    resample ``int(sr/rate) -> sr`` (TRUNCATING, exactly torchaudio's
    rounding — ``round()`` measured 15-18 dB against the independent torch
    oracle in tests/ta_oracle.py where the two differ), crop/pad to T.
    ``n_steps == 0`` returns the input.
    """

    def __init__(self, sample_rate: int, n_steps: int,
                 bins_per_octave: int = 12, n_fft: int = 512,
                 win_length: int | None = None, hop_length: int | None = None):
        self.sample_rate = int(sample_rate)
        self.n_steps = int(n_steps)
        self.bins_per_octave = int(bins_per_octave)
        self.n_fft = int(n_fft)
        self.win_length = int(win_length or n_fft)
        self.hop_length = int(hop_length or self.win_length // 4)
        # torchaudio: the STFT timeline's rate is 2^(-n/bins) — stretch
        # longer for upward shifts, then resample back shorter
        self.rate = 2.0 ** (-float(self.n_steps) / self.bins_per_octave)

    def geometry(self, T: int):
        """(frames, frames_out, len_stretch, orig) for an input of T."""
        frames = S.frame_count(T, self.n_fft, self.hop_length)
        frames_out = int(math.ceil(frames / self.rate))
        len_stretch = int(round(T / self.rate))
        orig = int(self.sample_rate / self.rate)  # int(), not round()
        return frames, frames_out, len_stretch, orig

    def __call__(self, x):
        x, mode = _norm_bt(x)
        if self.n_steps == 0:
            return _restore_bt(x, mode)
        T = x.shape[-1]
        _, frames_out, len_stretch, orig = self.geometry(T)
        y = _ta_shift_core(x, self.rate, self.n_fft, self.hop_length,
                           self.win_length, T, frames_out, len_stretch,
                           orig, self.sample_rate)
        return _restore_bt(y, mode)

    forward = __call__


class PitchShifter:
    """Fixed-shift adapter holding ``n_steps`` over a
    :class:`PhaseVocoderPitchShift` (reference ``PitchShifter``,
    1-PitchShifterWrapper.py:31-40)."""

    def __init__(self, n_steps: int, n_fft: int = 4096,
                 hop_length: int = 128, win_length: int = 1024):
        self.n_steps = int(n_steps)
        self.shifter = PhaseVocoderPitchShift(n_fft, hop_length, win_length)

    def __call__(self, x):
        return self.shifter(x, self.n_steps)

    forward = __call__
