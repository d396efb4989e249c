"""L3 — the flagship per-sub-band phase-vocoder pitch shifter.

PyTorch counterpart of ``pqmf_tpu/pipelines.py``'s
:class:`PQMFPitchShiftWrapper` (reference 1-PitchShifterWrapper.py:104-323):

    analysis conv (K1) -> batched matmul-DFT STFT of all bands -> stretch
    of every band at its own rate (padded to the max frame count, masked)
    -> masked OLA ISTFT -> per-band linear resample -> crossfade against
    the carried tail -> synthesis conv (K2)

with the crossfade state (``prev_tail``) threaded explicitly:
``pitchshift_fn(state, x) -> (state', y)``; ``forward_fn`` is the plain
round trip (K3). The middle is plain tensor code over all bands at once;
the convs are the hand-written kernels on a CUDA device and their plain
versions on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.ops import phase_vocoder as pv
from pqmf_tpu_torch.ops import resample as rs
from pqmf_tpu_torch.ops import stft as S
from pqmf_tpu_torch.streaming import StreamingPQMF

__all__ = ["PQMFPitchShiftWrapper", "derive_stft_geometry"]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _check_buffer(T: int, n_band: int, max_buffer_size, what: str = "input",
                  check_multiple: bool = True):
    """Input-length guard: the block must divide into bands and respect
    the declared host-buffer limit (``max_buffer_size=None`` opts into
    offline whole-file processing). ``check_multiple=False`` for sub-band
    inputs, whose full-rate length is a multiple by construction."""
    if check_multiple and T % n_band:
        raise ValueError(
            f"{what} length {T} must be a multiple of n_band={n_band}")
    if max_buffer_size is not None and T > max_buffer_size:
        raise ValueError(
            f"{what} length {T} exceeds max_buffer_size={max_buffer_size} "
            f"(the declared host buffer limit); construct the wrapper "
            f"with max_buffer_size=None (or larger) for offline "
            f"whole-file processing")


def _check_declared_buffers(m_buffer_size: int, max_buffer_size) -> None:
    """A wrapper whose nominal block exceeds its own declared host limit
    would reject every one of its own calls — refuse it at construction."""
    if max_buffer_size is not None and m_buffer_size > max_buffer_size:
        raise ValueError(
            f"m_buffer_size={m_buffer_size} exceeds "
            f"max_buffer_size={max_buffer_size}; raise max_buffer_size (or "
            f"pass max_buffer_size=None for offline use)")


def derive_stft_geometry(m_buffer_size: int, n_band: int):
    """The reference's buffer-size-derived per-band STFT geometry
    (1-PitchShifterWrapper.py:137-151): returns (win, hop, n_fft,
    band_overlap). Defaults (8192, 16) -> (512, 128, 512, 128)."""
    sub_len_est = max(16, int(m_buffer_size // max(1, n_band)))
    win = int(max(16, min(sub_len_est, 4096)))
    hop = max(1, win // 4)
    n_fft = min(_next_pow2(win), 4096)
    if n_fft < win:
        n_fft = win
    band_overlap = int(min(hop, max(0, win // 4)))
    return win, hop, n_fft, band_overlap


def _fused_band_pitchshift(bands, rates, frames_out, prev_tail, fade_out,
                           fade_in, n_fft, hop, win, Tb, FO_max,
                           crossfade=True, phase_rule="reference"):
    """Pitch-shift every sub-band at once.

    bands: [B, M, Tb]; rates: [M] f32; frames_out: [M] int64.
    crossfade True (reference semantics, batch==1 guard at
    1-PitchShifterWrapper.py:262): prev_tail [M, L].
    crossfade "batched" (multi-stream serving): prev_tail [M, B, L] —
    every batch row keeps its own carried tail.
    crossfade False: no blend, the tail is returned untouched.
    Returns (shifted [B, M, Tb], new_tail like prev_tail).
    """
    B, M, _ = bands.shape
    dev = bands.device
    f32 = torch.float32
    window = S.hann_window(win, dev)

    # --- batched STFT of all bands, band-major rows [M*B, Tb] ---
    x = bands.transpose(0, 1).reshape(M * B, Tb)
    if Tb < n_fft:  # reference pads short sub-bands right to n_fft
        x = F.pad(x, (0, n_fft - Tb))
    re, im = S.stft_ri(x, n_fft, hop, window, normalized=True)
    F_, frames = re.shape[1], re.shape[2]
    re = re.reshape(M, B, F_, frames)
    im = im.reshape(M, B, F_, frames)

    # f32-stepwise omega: the clamped boundary frames evaluate
    # princarg(-omega) exactly at the ±pi wrap (phase_advance_reference)
    omega = pv.phase_advance_reference(F_, hop, n_fft, dev)
    trim = n_fft // 2
    one_off = (n_fft - win) // 2  # placement of the 1-frame irfft fallback
    Ci, Si = S.idft_basis(n_fft, dev)

    # reference magphase + stretch rule, padded to FO_max and masked
    mag = torch.sqrt(re * re + im * im + 1e-12)
    phase = torch.atan2(im, re)
    j = torch.arange(FO_max, dtype=f32, device=dev)
    t_prime = j[None, :] * rates[:, None]  # [M, FO]
    t0 = torch.floor(t_prime).to(torch.int64).clamp(0, frames - 1)
    t1 = (t0 + 1).clamp_max(frames - 1)
    a = (t_prime - t0.to(f32))[:, None, None, :]  # [M, 1, 1, FO]
    mag0, phi0 = pv._select_frames(mag, phase, t0)
    mag1, phi1 = pv._select_frames(mag, phase, t1)
    mag_s = (1 - a) * mag0 + a * mag1
    om = omega[None, None, :, None]
    dp = pv.principal_angle(phi1 - phi0 - om)
    if phase_rule == "accumulate":
        # librosa/torchaudio running phase: accumulate wrapped advances
        incs = torch.cat([phi0[..., :1], (dp + om)[..., :-1]], dim=-1)
        phi = torch.cumsum(incs, dim=-1)
    else:  # the reference's per-frame-independent rule
        phi = phi0 + om + a * dp
    fmask = (torch.arange(FO_max, device=dev)[None, :]
             < frames_out[:, None]).to(f32)  # [M, FO]
    fm = fmask[:, None, None, :]
    re_s = mag_s * torch.cos(phi) * fm
    im_s = mag_s * torch.sin(phi) * fm

    # masked OLA ISTFT over the full (untrimmed) buffer
    y, wsq = S.istft_ri_parts(re_s, im_s, n_fft, hop, window,
                              normalized=True, frame_mask=fmask[:, None, :])
    ola = y / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))  # [M,B,tot]
    total = ola.shape[-1]
    i = torch.arange(total, device=dev)[None, :]
    fo = frames_out[:, None]
    # center-fit of the istft output (length (fo-1)*hop) into
    # length_stretch = (fo-1)*hop + n_fft lands at buffer positions
    # [trim, trim + (fo-1)*hop) — a pure mask
    valid = (i >= trim) & (i < trim + (fo - 1) * hop)  # [M, total]
    p_multi = ola * valid[:, None, :].to(f32)

    # reference 1-frame fallback: direct (normalized-in, unscaled-out)
    # irfft of frame 0, cropped to win, centered in n_fft
    with fb.full_f32():
        y1 = (torch.matmul(re_s[..., 0], Ci)
              + torch.matmul(im_s[..., 0], Si))  # [M, B, n_fft]
    p_one = torch.zeros_like(ola)
    p_one[..., one_off:one_off + win] = y1[..., :win]
    P = torch.where((frames_out == 1)[:, None, None], p_one, p_multi)

    # per-band resample back to Tb from each band's stretch length
    length_stretch = ((frames_out - 1) * hop + n_fft).clamp_min(1)
    shifted = rs.interpolate_linear_dynamic(P, length_stretch[:, None], Tb)

    # --- crossfade against the carried per-band tail ---
    L = prev_tail.shape[-1]
    wants_crossfade = (crossfade == "batched"
                       or (crossfade is True and B == 1))
    if wants_crossfade and L > 0 and Tb < L:
        # the reference silently skips the blend here (:262) and freezes
        # the tail; this build refuses such blocks
        raise ValueError(
            f"sub-band block length {Tb} is shorter than the crossfade "
            f"overlap {L}: blocks must be >= n_band*band_overlap = "
            f"{M * L} samples for this wrapper's geometry; construct the "
            f"wrapper with a matching m_buffer_size for smaller blocks")
    if crossfade == "batched" and L > 0:
        # per-batch tails [M, B, L]: every stream crossfades independently
        blended = prev_tail * fade_out + shifted[:, :, :L] * fade_in
        new_tail = shifted[:, :, Tb - L:].contiguous()
        shifted = torch.cat([blended, shifted[:, :, L:]], dim=-1)
    elif crossfade is True and L > 0 and B == 1:
        # reference semantics: single shared tail, batch==1 only (:262)
        blended = prev_tail * fade_out + shifted[:, 0, :L] * fade_in
        new_tail = shifted[:, 0, Tb - L:].contiguous()
        shifted = torch.cat([blended[:, None], shifted[:, :, L:]], dim=-1)
    else:
        new_tail = prev_tail
    return shifted.transpose(0, 1), new_tail  # [B, M, Tb]


class _RegistryMixin:
    """conTorchionist protocol surface (PQMFWrapper.py:27-49): the host
    introspects exported modules via get_methods()/get_attributes() plus
    per-method channel counts and buffer-size attributes."""

    _methods: list
    _attributes: list

    def get_methods(self):
        return list(self._methods)

    def get_attributes(self):
        return list(self._attributes)

    def attribute_dict(self):
        return {name: getattr(self, name) for name in self._attributes}


class PQMFPitchShiftWrapper(_RegistryMixin):
    """Flagship: per-band phase-vocoder pitch shift with cross-block
    crossfade (reference 1-PitchShifterWrapper.py:104-323), on one device.

    Pure API: ``init_state()`` then ``pitchshift_fn(state, x) ->
    (state', y)``; ``init_streams(S)`` then ``pitchshift_streams(states,
    x)`` for S independent streams. Stateful facade: ``pitchshift(x)``
    carries state internally like the reference module.
    """

    def __init__(self, attenuation: int = 100, n_band: int = 16,
                 m_buffer_size: int = 8192, sample_rate: int = 44100,
                 shifts_in_semitones=None, precision: str = "highest",
                 phase_rule: str = "reference",
                 max_buffer_size: int | None = 16384, device="cpu"):
        self.n_band = n_band
        self.attenuation = attenuation
        self.sample_rate = sample_rate
        self.precision = fb.check_precision(precision)
        self.pqmf = StreamingPQMF(attenuation, n_band, precision=precision,
                                  device=device)
        self.device = self.pqmf.device

        self._methods = ["forward", "pitchshift"]
        self._attributes = [
            "n_band", "attenuation",
            "forward_in_ch", "forward_out_ch",
            "pitchshift_in_ch", "pitchshift_out_ch",
            "m_buffer_size", "max_buffer_size",
        ]
        self.forward_in_ch = 1
        self.forward_out_ch = 1
        self.pitchshift_in_ch = 1
        self.pitchshift_out_ch = 1
        self.m_buffer_size = m_buffer_size
        self.max_buffer_size = max_buffer_size
        _check_declared_buffers(m_buffer_size, max_buffer_size)

        if shifts_in_semitones is None:
            self.shifts = list(range(n_band))  # chromatic default (:131)
        else:
            self.shifts = list(shifts_in_semitones)
        if len(self.shifts) != n_band:
            raise ValueError(
                f"expected {n_band} shifts, got {len(self.shifts)}")

        self.win, self.hop, self.n_fft, self.band_overlap = (
            derive_stft_geometry(m_buffer_size, n_band))

        # per-band rates from static integer semitone shifts (:159-161)
        n_steps = [int(round(float(s))) for s in self.shifts]
        rates = [1.0 / (2.0 ** (s / 12.0)) for s in n_steps]
        self._rates = torch.tensor(rates, dtype=torch.float32,
                                   device=self.device)
        self._rates_py = rates
        self.Tb = m_buffer_size // n_band
        self._plans = {}
        if phase_rule not in ("reference", "accumulate"):
            raise ValueError(f"unknown phase_rule {phase_rule!r}: expected "
                             "'reference' or 'accumulate'")
        self.phase_rule = phase_rule

        L = self.band_overlap
        full = S.hann_window(2 * L, self.device) if L > 0 else None
        self._fade_out = full[:L] if L > 0 else None
        self._fade_in = full[L:] if L > 0 else None
        self._state = self.init_state()

    # -- pure functional API -------------------------------------------------

    def init_state(self):
        """Crossfade state: per-band previous tail (reference buffers
        :172-180)."""
        return {"prev_tail": torch.zeros((self.n_band, self.band_overlap),
                                         device=self.device)}

    def _block(self, x):
        """x [1, T] / [B, 1, T] (array or tensor) -> [B, 1, T] on device."""
        x = self.pqmf.as_tensor(x)
        if x.ndim == 2:
            x = x[None]
        if not (x.ndim == 3 and x.shape[1] == 1):
            raise ValueError(
                "input must be [1, buffer_size] or [batch, 1, buffer_size]")
        _check_buffer(x.shape[-1], self.n_band, self.max_buffer_size)
        return x

    def decompose(self, x):
        return self.pqmf.forward(self._block(x))

    def inverse(self, x):
        x = self.pqmf.as_tensor(x)
        if not (x.ndim == 3 and x.shape[1] == self.n_band):
            raise ValueError(
                f"input must be [batch, {self.n_band}, T']")
        _check_buffer(x.shape[-1] * self.n_band, self.n_band,
                      self.max_buffer_size, what="sub-band signal",
                      check_multiple=False)
        return self.pqmf.inverse(x)

    def _plan(self, Tb: int):
        """Static stretch plan for a band length: the reference derives
        frame counts from each call's input length (short inputs pad to
        n_fft), so blocks shorter than m_buffer_size get their own plan.
        Returns (frames_out [M] int64 on the device, max frames_out)."""
        plan = self._plans.get(Tb)
        if plan is None:
            Tp = max(Tb, self.n_fft)
            frames = S.frame_count(Tp, self.n_fft, self.hop)
            fo = [max(1, int(math.floor(frames / r)))
                  for r in self._rates_py]
            plan = (torch.tensor(np.asarray(fo, np.int64),
                                 device=self.device), max(fo))
            self._plans[Tb] = plan
        return plan

    def _shift(self, sub, prev_tail, crossfade):
        Tb = sub.shape[-1]
        frames_out, FO_max = self._plan(Tb)
        return _fused_band_pitchshift(
            sub, self._rates, frames_out, prev_tail, self._fade_out,
            self._fade_in, self.n_fft, self.hop, self.win, Tb, FO_max,
            crossfade=crossfade, phase_rule=self.phase_rule)

    def pitchshift_fn(self, state, x):
        """(state, x [1,T] | [B,1,T]) -> (state', y [B, T]). With B > 1
        there is no crossfade and the tail passes through untouched (the
        reference's batch==1 guard)."""
        sub = self.decompose(x)  # [B, M, Tb]
        shifted, new_tail = self._shift(sub, state["prev_tail"],
                                        crossfade=(sub.shape[0] == 1))
        y = self.inverse(shifted)  # [B, 1, T]
        return {"prev_tail": new_tail}, y[:, 0, :]

    def forward_fn(self, x):
        """Pure round trip (reference ``forward``, :303-316) -> [B, T],
        through ``StreamingPQMF.roundtrip`` (K3 on a CUDA device)."""
        return self.pqmf.roundtrip(self._block(x))[:, 0, :]

    # -- multi-stream serving -------------------------------------------------

    def init_streams(self, n_streams: int):
        """Per-stream crossfade state [S, M, L] for ``n_streams``
        independent real-time streams."""
        return {"prev_tail": torch.zeros(
            (n_streams, self.n_band, self.band_overlap), device=self.device)}

    def pitchshift_streams(self, states, x):
        """Stateful step over S independent streams at once, each with its
        own crossfade tail; the streams ride the batch axis of the same
        kernels. x: [n_streams, T] -> (states', y [n_streams, T])."""
        x = self.pqmf.as_tensor(x)
        sub = self.decompose(x[:, None, :])  # [S, M, Tb]
        tails = states["prev_tail"].transpose(0, 1)  # [M, S, L]
        shifted, new_tails = self._shift(sub, tails, crossfade="batched")
        y = self.inverse(shifted)
        return ({"prev_tail": new_tails.transpose(0, 1).contiguous()},
                y[:, 0, :])

    # -- stateful facade (reference-style implicit buffers) ------------------

    def reset(self):
        self._state = self.init_state()

    def pitchshift(self, x):
        self._state, y = self.pitchshift_fn(self._state, x)
        return y

    processing = pitchshift

    def forward(self, x):
        return self.forward_fn(x)

    __call__ = forward
