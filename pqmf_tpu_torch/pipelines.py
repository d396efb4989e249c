"""L3 — the wrappers, the torchaudio variant and the block-streaming harness.

PyTorch counterpart of ``pqmf_tpu/pipelines.py``:

- :class:`PQMFWrapper` (reference PQMFWrapper.py:17-92): analysis,
  synthesis and both, on the streaming PQMF's offline convs K1/K2;
- :class:`PQMFPitchShiftWrapper`, the flagship (reference
  1-PitchShifterWrapper.py:104-323)::

    analysis conv (K1) -> batched matmul-DFT STFT of all bands -> stretch
    of every band at its own rate (padded to the max frame count, masked)
    -> masked OLA ISTFT -> per-band linear resample -> crossfade against
    the carried tail -> synthesis conv (K2)

  with the crossfade state (``prev_tail``) threaded explicitly:
  ``pitchshift_fn(state, x) -> (state', y)``; ``forward_fn`` is the plain
  round trip (K3);
- :class:`PQMFPitchShiftWrapperTA`, the torchaudio variant (reference
  PQMFPsWrapper.py:31-150): K1, then torchaudio's per-band pitch shift of
  every band at once (reflect-pad STFT, running-phase stretch, masked
  ISTFT, banded windowed-sinc resample), then K2;
- :func:`stream_ola`, the block-streaming overlap-add harness (reference
  2-TestBlocks.py:86-126).

The middles are plain tensor code over all bands at once; the convs are
the hand-written kernels on a CUDA device and their plain versions on the
CPU. Every wrapper takes the JAX package's precision tiers
(``precision=``): the convs run at the tier (K1t/K2t/K3t at ``"bf16x3"``
and ``"default"``), the middles' DFT matmuls round their operands to bf16
at ``"default"`` only, and the resample stays in full f32 (JAX hard-codes
HIGHEST there, ``pqmf_tpu/pipelines.py:311-313``).

Every wrapper takes ``mesh=`` (a (data, band) ``DeviceMesh``) and hands it
to its ``StreamingPQMF``: the batch rides the data axis, and every rank
runs K1 on its band shard, its bands' middle (their rows of the per-band
rates, plans and crossfade tail) and K2 on its shard, then the band
``all_reduce``. Inputs are global tensors or ``DTensor`` s; outputs and the
carried state are ``DTensor`` s (``streaming.BandLayout``). On the card the
steps' CUDA graphs hold the band all-reduce (NCCL only, ``graphs.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch import graphs
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.ops import phase_vocoder as pv
from pqmf_tpu_torch.ops import resample as rs
from pqmf_tpu_torch.ops import stft as S
from pqmf_tpu_torch.shifters import TorchaudioPitchShift
from pqmf_tpu_torch.streaming import StreamingPQMF

__all__ = [
    "PQMFWrapper",
    "PQMFPitchShiftWrapper",
    "PQMFPitchShiftWrapperTA",
    "derive_stft_geometry",
    "stream_ola",
]


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
                           crossfade=True, phase_rule="reference",
                           precision="highest"):
    """Pitch-shift every sub-band at once.

    bands: [B, M, Tb]; rates: [M] f32; frames_out: [M] int64.
    crossfade True (reference semantics, batch==1 guard at
    1-PitchShifterWrapper.py:262): prev_tail [M, L].
    crossfade "batched" (multi-stream serving): prev_tail [M, B, L] —
    every batch row keeps its own carried tail.
    crossfade False: no blend, the tail is returned untouched.
    ``precision``: the DFT matmuls' tier (``ops.stft.dft_matmul``).
    Returns (shifted [B, M, Tb], new_tail like prev_tail).
    """
    B, M, _ = bands.shape
    dev = bands.device
    f32 = torch.float32
    window = S.hann_window(win, device=dev)

    # --- batched STFT of all bands, band-major rows [M*B, Tb] ---
    x = bands.transpose(0, 1).reshape(M * B, Tb)
    if Tb < n_fft:  # reference pads short sub-bands right to n_fft
        x = F.pad(x, (0, n_fft - Tb))
    re, im = S.stft_ri(x, n_fft, hop, window, normalized=True,
                       precision=precision)
    F_, frames = re.shape[1], re.shape[2]
    re = re.reshape(M, B, F_, frames)
    im = im.reshape(M, B, F_, frames)

    # f32-stepwise omega: the clamped boundary frames evaluate
    # princarg(-omega) exactly at the ±pi wrap (phase_advance_reference)
    omega = pv.phase_advance_reference(F_, hop, n_fft, device=dev)
    trim = n_fft // 2
    one_off = (n_fft - win) // 2  # placement of the 1-frame irfft fallback
    Ci, Si = S.idft_basis(n_fft, device=dev)

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
                              normalized=True, frame_mask=fmask[:, None, :],
                              precision=precision)
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
    y1 = (S.dft_matmul(re_s[..., 0], Ci, precision)
          + S.dft_matmul(im_s[..., 0], Si, precision))  # [M, B, n_fft]
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


class PQMFWrapper(_RegistryMixin):
    """Plain analysis/synthesis wrapper (reference PQMFWrapper.py:17-92),
    on one device.

    Methods: ``forward`` (mono -> n_band sub-bands), ``inverse``,
    ``process`` (-> (reconstructed, subbands), the reference's actual
    return order — its docstring says the opposite, SURVEY §2.5-5).
    """

    def __init__(self, attenuation: int = 100, n_band: int = 16,
                 m_buffer_size: int = 512, precision: str = "highest",
                 mesh=None, max_buffer_size: int | None = 16384,
                 device="cuda"):
        self.n_band = n_band
        self.attenuation = attenuation
        self.pqmf = StreamingPQMF(attenuation, n_band, precision=precision,
                                  device=device, mesh=mesh)
        self.device = self.pqmf.device
        self._methods = ["forward", "inverse", "process"]
        self._attributes = [
            "n_band", "attenuation",
            "forward_in_ch", "forward_out_ch",
            "inverse_in_ch", "inverse_out_ch",
            "process_in_ch", "process_out_ch",
            "m_buffer_size", "max_buffer_size",
        ]
        # exact reference values (PQMFWrapper.py:34-41)
        self.forward_in_ch = 1
        self.forward_out_ch = 1
        self.inverse_in_ch = 1
        self.inverse_out_ch = 1
        self.process_in_ch = 1
        self.process_out_ch = 2
        self.m_buffer_size = m_buffer_size
        self.max_buffer_size = max_buffer_size
        _check_declared_buffers(m_buffer_size, max_buffer_size)

    def forward(self, x):
        """x [1, T] / [B, 1, T] (array or tensor) -> [B, n_band, T/n_band]."""
        x = self.pqmf.as_tensor(x)
        if x.ndim == 2:
            x = x[None]
        if not (x.ndim == 3 and x.shape[1] == 1):
            raise ValueError(
                "input must be [1, buffer_size] or [batch, 1, buffer_size]")
        _check_buffer(x.shape[-1], self.n_band, self.max_buffer_size)
        return self.pqmf.forward(x)

    def inverse(self, x):
        """[B, n_band, T'] -> [B, 1, T'*n_band]."""
        x = self.pqmf.as_tensor(x)
        if not (x.ndim == 3 and x.shape[1] == self.n_band):
            raise ValueError(
                f"input must be [batch, {self.n_band}, T'] or "
                f"[1, {self.n_band}, T']")
        _check_buffer(x.shape[-1] * self.n_band, self.n_band,
                      self.max_buffer_size, what="sub-band signal",
                      check_multiple=False)
        return self.pqmf.inverse(x)

    def process(self, x):
        subbands = self.forward(x)
        reconstructed = self.inverse(subbands)
        return reconstructed, subbands

    __call__ = forward


class PQMFPitchShiftWrapper(_RegistryMixin):
    """Flagship: per-band phase-vocoder pitch shift with cross-block
    crossfade (reference 1-PitchShifterWrapper.py:104-323), on one device.

    Pure API: ``init_state()`` then ``pitchshift_fn(state, x) ->
    (state', y)``; ``init_streams(S)`` then ``pitchshift_streams(states,
    x)`` for S independent streams. Stateful facade: ``pitchshift(x)``
    carries state internally like the reference module.

    On a CUDA device both steps are CUDA graphs (``graphs.py``), one per
    (step, B, T, precision, device, ``pqmf.weights_version``), kept on the
    wrapper: the first call of a shape runs the eager body and captures
    it, later calls replay it; ``pqmf.set_weights`` drops them.

    Under a ``mesh`` the state is a ``DTensor``: the tail [M, L] split over
    band ([S, M, L] for ``init_streams``, over data and band); ``y`` is
    split over data (when B divides by it) and replicated over band.
    """

    def __init__(self, attenuation: int = 100, n_band: int = 16,
                 m_buffer_size: int = 8192, sample_rate: int = 44100,
                 shifts_in_semitones=None, precision: str = "highest",
                 phase_rule: str = "reference", mesh=None,
                 max_buffer_size: int | None = 16384, device="cuda"):
        self.n_band = n_band
        self.attenuation = attenuation
        self.sample_rate = sample_rate
        self.precision = fb.check_precision(precision)
        self.pqmf = StreamingPQMF(attenuation, n_band, precision=precision,
                                  device=device, mesh=mesh)
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
        full = S.hann_window(2 * L, device=self.device) if L > 0 else None
        # copies, not views of the cached window: each is a tensor of its
        # own in an exported program
        self._fade_out = full[:L].clone() if L > 0 else None
        self._fade_in = full[L:].clone() if L > 0 else None
        self._state = self.init_state()
        self._graphs = {}          # the steps' CUDA graphs (graphs.call)
        self._stream_ola_fns = {}  # stream_ola's programs

    # -- pure functional API -------------------------------------------------

    def init_state(self):
        """Crossfade state: per-band previous tail (reference buffers
        :172-180)."""
        lay = self.pqmf._layout
        tail = torch.zeros((self.n_band if lay is None else lay.Mb,
                            self.band_overlap), device=self.device)
        return {"prev_tail": tail if lay is None
                else lay.wrap(tail, band_dim=0)}

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
        """The middle of this rank's bands (all bands without a mesh): their
        rows of the rates and the plan, the padding to the max frame count
        of all bands kept."""
        Tb = sub.shape[-1]
        frames_out, FO_max = self._plan(Tb)
        sl = self.pqmf.band_slice
        return _fused_band_pitchshift(
            sub, self._rates[sl], frames_out[sl], prev_tail, self._fade_out,
            self._fade_in, self.n_fft, self.hop, self.win, Tb, FO_max,
            crossfade=crossfade, phase_rule=self.phase_rule,
            precision=self.precision)

    def _key(self, entry: str, B: int, T: int) -> tuple:
        """A step's graph key: what the JAX package makes static."""
        return (entry, B, T, self.precision, self.device,
                self.pqmf.weights_version)

    def pitchshift_fn(self, state, x):
        """(state, x [1,T] | [B,1,T]) -> (state', y [B, T]). With B > 1
        there is no crossfade and the tail passes through untouched (the
        reference's batch==1 guard). A CUDA graph per (B, T) on the card."""
        x = self._block(x)
        lay = self.pqmf._layout
        if lay is not None:
            return self._pitchshift_sharded(lay, state, x, graphed=True)
        return graphs.call(self._graphs,
                           self._key("pitchshift_fn", x.shape[0],
                                     x.shape[-1]),
                           self._pitchshift_fn_eager, state, x)

    def _pitchshift_fn_eager(self, state, x, crossfade=None):
        """The step on this rank's rows and bands (all of them without a
        mesh): K1, the middle, K2 (and the band sum). ``crossfade``
        defaults to the reference's batch==1 guard on x's batch; a
        sharded step passes the global batch's."""
        x = self._block(x)
        sub = self.pqmf._forward_local(x)  # [B, Mb, Tb]
        if crossfade is None:
            crossfade = x.shape[0] == 1
        shifted, new_tail = self._shift(sub, state["prev_tail"], crossfade)
        y = self.pqmf._inverse_local(shifted)  # [B, 1, T]
        return {"prev_tail": new_tail}, y[:, 0, :]

    def _pitchshift_sharded(self, lay, state, x, graphed: bool):
        """``pitchshift_fn`` over ``lay`` (``streaming.BandLayout``): this
        rank's rows of x and bands of the tail through the step (its CUDA
        graph when ``graphed``, on the card), the results made DTensors."""
        B, T = x.shape[0], x.shape[-1]
        args = ({"prev_tail": lay.local(state["prev_tail"], band_dim=0)},
                lay.local(x, data_dim=0), B == 1)
        if graphed:
            new, y = graphs.call(self._graphs,
                                 self._key("pitchshift_fn", B, T),
                                 self._pitchshift_fn_eager, *args,
                                 group=lay.group)
        else:
            new, y = self._pitchshift_fn_eager(*args)
        return ({"prev_tail": lay.wrap(new["prev_tail"], band_dim=0)},
                lay.wrap(y, data_dim=0, batch=B))

    def forward_fn(self, x):
        """Pure round trip (reference ``forward``, :303-316) -> [B, T],
        through ``StreamingPQMF.roundtrip`` (K3 on a CUDA device; K1 and K2
        on the band shard under a mesh)."""
        x = self._block(x)
        lay = self.pqmf._layout
        if lay is None:
            return self.pqmf.roundtrip(x)[:, 0, :]
        y = self.pqmf._roundtrip_local(lay.local(x, data_dim=0))
        return lay.wrap(y[:, 0, :], data_dim=0, batch=x.shape[0])

    # -- multi-stream serving -------------------------------------------------

    def init_streams(self, n_streams: int):
        """Per-stream crossfade state [S, M, L] for ``n_streams``
        independent real-time streams."""
        lay = self.pqmf._layout
        if lay is None:
            return {"prev_tail": torch.zeros(
                (n_streams, self.n_band, self.band_overlap),
                device=self.device)}
        rows = (n_streams // lay.data if n_streams % lay.data == 0
                else n_streams)
        tail = torch.zeros((rows, lay.Mb, self.band_overlap),
                           device=self.device)
        return {"prev_tail": lay.wrap(tail, data_dim=0, band_dim=1,
                                      batch=n_streams)}

    def pitchshift_streams(self, states, x):
        """Stateful step over S independent streams at once, each with its
        own crossfade tail; the streams ride the batch axis of the same
        kernels. x: [n_streams, T] -> (states', y [n_streams, T]). A CUDA
        graph per (S, T) on the card."""
        x = self.pqmf.as_tensor(x)
        S, T = x.shape[0], x.shape[-1]
        key = self._key("pitchshift_streams", S, T)
        lay = self.pqmf._layout
        if lay is None:
            return graphs.call(self._graphs, key,
                               self._pitchshift_streams_eager, states, x)
        tails = lay.local(states["prev_tail"], data_dim=0, band_dim=1)
        new, y = graphs.call(self._graphs, key,
                             self._pitchshift_streams_eager,
                             {"prev_tail": tails}, lay.local(x, data_dim=0),
                             group=lay.group)
        return ({"prev_tail": lay.wrap(new["prev_tail"], data_dim=0,
                                       band_dim=1, batch=S)},
                lay.wrap(y, data_dim=0, batch=S))

    def _pitchshift_streams_eager(self, states, x):
        sub = self.pqmf._forward_local(self._block(x[:, None, :]))
        tails = states["prev_tail"].transpose(0, 1)  # [Mb, S, L]
        shifted, new_tails = self._shift(sub, tails, crossfade="batched")
        y = self.pqmf._inverse_local(shifted)
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


# ---------------------------------------------------------------------------
# the block-streaming harness
# ---------------------------------------------------------------------------


def _stream_ola_program(wrapper, block: int, hop: int, n_frames: int,
                        C: int, T: int) -> graphs.Program:
    """The whole harness for one static geometry (the JAX package's
    ``_stream_ola_program``): right-pad to the frame grid -> frame -> Hann
    window -> the stateful pitch step over every block, the crossfade state
    carried -> all blocks' round trips as one batch (one K3 on the card) ->
    windowed overlap-add / sum of window^2 -> trim back to T. On a CUDA
    device the whole ``run`` is one CUDA graph (``graphs.Program``): one
    launch a call once captured. On the CPU it runs eagerly. Under a mesh
    every rank runs every stream on its bands (the band sums in the
    graph), and the outputs are DTensors replicated over the mesh."""
    if C == 1:
        step = wrapper._pitchshift_fn_eager
    else:
        step = wrapper._pitchshift_streams_eager
    total = (n_frames - 1) * hop + block
    lay = wrapper.pqmf._layout
    Mb = wrapper.n_band if lay is None else lay.Mb
    L = wrapper.band_overlap

    def run(x):
        window = S.hann_window(block, device=x.device)
        framed = S._frame_signal(F.pad(x, (0, total - T)), block, hop,
                                 n_frames)
        blocks = (framed * window).transpose(0, 1)  # [N, C, block]
        # this rank's bands of the zero tails (all of them without a mesh)
        state = {"prev_tail": x.new_zeros(
            (Mb, L) if C == 1 else (C, Mb, L))}
        outs = []
        for blk in blocks:  # [C, block] -> [C, block]
            state, out = step(state, blk)
            outs.append(out)
        outs = torch.stack(outs, dim=1)  # [C, N, block]
        recs = wrapper.pqmf._roundtrip_local(
            wrapper._block(blocks.reshape(n_frames * C, 1, block)))[:, 0, :]
        recs = recs.reshape(n_frames, C, block).transpose(0, 1)

        wsq = (window * window).expand(n_frames, block)
        norm = S._ola(wsq, block, hop) + 1e-8  # the harness's epsilon
        pitch = S._ola(outs * window, block, hop) / norm
        recon = S._ola(recs * window, block, hop) / norm
        return pitch[:, :T], recon[:, :T]

    return graphs.Program(run, wrapper.device,
                          None if lay is None else lay.group)


def stream_ola(wrapper, x, block: int, overlap: int | None = None):
    """The block-streaming harness (reference 2-TestBlocks.py:86-126) over
    a flagship wrapper: Hann-windowed overlapping blocks -> the stateful
    pitch-shift step per block, crossfade state carried -> windowed
    overlap-add normalized by the accumulated window energy (+ 1e-8), and
    beside it the plain round trip of the same blocks.

    x: [C, T] (or [T]) array or tensor on the wrapper's device. C == 1
    runs the flagship step from ``init_state()``; C > 1 runs one serving
    stream per channel (the ``pitchshift_streams`` step from
    ``init_streams(C)``), each with its own crossfade state. The round trip
    carries no state, so all blocks go through ``forward_fn`` as one batch
    (one K3 on a CUDA device; one K1 and one K2 per block for the pitch
    stream).

    The whole harness is one program per (block, hop, T, C,
    ``pqmf.weights_version``), cached on the wrapper
    (``wrapper._stream_ola_fns``) as the JAX package caches its XLA
    programs: on a CUDA device one CUDA graph, whose first call runs the
    harness eagerly and captures it, and every later call of the same
    geometry one replay; ``pqmf.set_weights`` evicts the programs of the
    old bank. Returns (pitch_stream [C, T], recon_stream [C, T]) on the
    wrapper's device (DTensors replicated over a wrapper's mesh).
    """
    x = wrapper.pqmf.as_tensor(x)
    lay = wrapper.pqmf._layout
    if lay is not None:
        x = lay.local(x)  # the global signal, on every rank
    if x.ndim == 1:
        x = x[None]
    C, T = x.shape
    hop = block - (block // 2 if overlap is None else overlap)
    if hop <= 0 or hop > block:
        raise ValueError("overlap must be in [0, block-1]")
    n_frames = 1 if T <= block else -(-(T - block) // hop) + 1

    fns = wrapper._stream_ola_fns
    ver = wrapper.pqmf.weights_version
    key = (block, hop, T, C, ver)
    run = fns.get(key)
    if run is None:
        # weights_version only advances: programs of an older bank can
        # never be hit again, and a graph of one reads freed banks
        for stale in [k for k in fns if k[4] != ver]:
            del fns[stale]
        run = fns[key] = _stream_ola_program(wrapper, block, hop, n_frames,
                                             C, T)
    if lay is None:
        return run(x)
    return tuple(lay.wrap(t) for t in run(x))


# ---------------------------------------------------------------------------
# the torchaudio variant
# ---------------------------------------------------------------------------


def _fused_ta_pitchshift(bands, plan, n_fft, hop, win, precision="highest"):
    """torchaudio's pitch shift of every band at once (reference per-band
    loop: PQMFPsWrapper.py:126-144).

    bands: [B, M, Tb]; ``plan`` from ``PQMFPitchShiftWrapperTA._ta_plan``.
    Per band: rates [M] f32, frames_out / len_stretch [M] int64, zero_shift
    [M] (1 where n_steps == 0), banded resample weights W [M, Tb, K] and
    window starts ``start`` [M, Tb] into the ``pad_left``-offset stretch
    buffer of length Lbuf (see
    :func:`~pqmf_tpu_torch.ops.resample.banded_resample_plan`). The
    resample is the banded gather ``z[j] = sum_k W[j, k] y[start[j] + k]``
    (full f32 at every tier). ``precision``: the DFT matmuls' tier.
    Returns shifted [B, M, Tb]."""
    (rates, frames_out, len_stretch, zero_shift, W, start, FO_max, pad_left,
     Lbuf) = plan
    B, M, Tb = bands.shape
    dev = bands.device
    window = S.hann_window(win, device=dev)

    # torchaudio's STFT of all bands, band-major rows [M*B, Tb]
    x = bands.transpose(0, 1).reshape(M * B, Tb)
    re, im = S.ta_stft_ri(x, n_fft, hop, window, precision)
    F_, frames = re.shape[1], re.shape[2]
    omega = pv.phase_advance(F_, hop, n_fft, device=dev)
    re_s, im_s = pv.stretch_accumulate(re.reshape(M, B, F_, frames),
                                       im.reshape(M, B, F_, frames),
                                       rates, omega, FO_max)

    # masked OLA ISTFT, then torch.istft(length=ls) per band: the samples
    # from n_fft//2 on, zero from ls on, placed pad_left into the buffer
    fmask = (torch.arange(FO_max, device=dev)[None, :]
             < frames_out[:, None]).to(torch.float32)  # [M, FO]
    y, wsq = S.istft_ri_parts(re_s, im_s, n_fft, hop, window,
                              normalized=False, frame_mask=fmask[:, None, :],
                              precision=precision)
    out = y / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    ystr = out[..., n_fft // 2:]  # [M, B, L]
    L = ystr.shape[-1]
    keep = torch.arange(L, device=dev)[None, :] < len_stretch[:, None]
    ystr = ystr * keep[:, None, :].to(ystr.dtype)
    ystr = F.pad(ystr, (pad_left, Lbuf - pad_left - L))

    K = W.shape[-1]
    idx = (start[:, :, None] + torch.arange(K, device=dev)).reshape(M, 1, -1)
    taps = torch.gather(ystr, -1, idx.expand(M, B, Tb * K))
    z = (taps.reshape(M, B, Tb, K) * W[:, None]).sum(-1)  # [M, B, Tb]
    # n_steps == 0 bands pass through untouched (torchaudio's early-out)
    z = torch.where(zero_shift[:, None, None] > 0, bands.transpose(0, 1), z)
    return z.transpose(0, 1)


class PQMFPitchShiftWrapperTA(_RegistryMixin):
    """torchaudio-variant wrapper (reference PQMFPsWrapper.py:31-150), on
    one device: per-band :class:`~pqmf_tpu_torch.shifters.TorchaudioPitchShift`
    at the sub-band sample rate ``round(sr / n_band)``, center crop / pad
    back, reconstruct.

    ``pitchshifter`` runs analysis (K1), every band's shift at once (the
    per-band resample ratios batch through the banded sinc plan) and
    synthesis (K2), on a CUDA device as a CUDA graph per (B, T) (the JAX
    package's ``_pitchshifter_jit``); ``pitchshifter_loop`` keeps the
    reference's per-band structure as its parity oracle. Under a ``mesh``
    each rank shifts its bands (its rows of the plan) between K1 and K2 on
    its shard, the batch split over data, and ``y`` is a DTensor.
    """

    def __init__(self, attenuation: int = 100, n_band: int = 16,
                 m_buffer_size: int = 512, sample_rate: int = 44100,
                 shifts_in_semitones=None, precision: str = "highest",
                 mesh=None, max_buffer_size: int | None = 8192,
                 device="cuda"):
        self.n_band = n_band
        self.attenuation = attenuation
        self.sample_rate = sample_rate
        self.precision = fb.check_precision(precision)
        self.pqmf = StreamingPQMF(attenuation, n_band, precision=precision,
                                  device=device, mesh=mesh)
        self.device = self.pqmf.device

        self._methods = ["forward", "inverse", "pitchshifter"]
        self._attributes = [
            "n_band", "attenuation",
            "forward_in_ch", "forward_out_ch",
            "inverse_in_ch", "inverse_out_ch",
            "pitchshifter_in_ch", "pitchshifter_out_ch",
            "m_buffer_size", "max_buffer_size",
        ]
        # exact reference values (PQMFPsWrapper.py:37-51)
        self.forward_in_ch = 1
        self.forward_out_ch = 1
        self.inverse_in_ch = 1
        self.inverse_out_ch = 1
        self.pitchshifter_in_ch = 1
        self.pitchshifter_out_ch = 2
        self.m_buffer_size = m_buffer_size
        self.max_buffer_size = max_buffer_size
        _check_declared_buffers(m_buffer_size, max_buffer_size)

        sub_sr = int(round(float(sample_rate) / float(max(1, n_band))))
        self.sub_band_sample_rate = sub_sr
        if shifts_in_semitones is None:
            self.shifts = list(range(n_band))  # chromatic default
        else:
            self.shifts = list(shifts_in_semitones)
        if len(self.shifts) != n_band:
            raise ValueError(
                f"expected {n_band} shifts, got {len(self.shifts)}")
        # Python's round: half to even, as the JAX package and torch round
        self.pitch_shifters = [
            TorchaudioPitchShift(sub_sr, int(round(float(s))))
            for s in self.shifts
        ]
        sh0 = self.pitch_shifters[0]
        self._n_fft, self._win, self._hop = (sh0.n_fft, sh0.win_length,
                                             sh0.hop_length)
        self._ta_plans = {}
        self._graphs = {}  # the block's CUDA graphs (graphs.call)

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

    def forward(self, x):
        """[B, 1, T] -> [B, n_band, T/n_band] (one K1 on a CUDA device)."""
        return self.pqmf.forward(self._block(x))

    def inverse(self, x):
        """[B, n_band, T'] -> [B, 1, T'*n_band] (one K2 on a CUDA device)."""
        x = self.pqmf.as_tensor(x)
        if not (x.ndim == 3 and x.shape[1] == self.n_band):
            raise ValueError(f"input must be [batch, {self.n_band}, T']")
        _check_buffer(x.shape[-1] * self.n_band, self.n_band,
                      self.max_buffer_size, what="sub-band signal",
                      check_multiple=False)
        return self.pqmf.inverse(x)

    def _ta_plan(self, Tb: int):
        """Per-band plan for band length Tb, cached per Tb: stretch
        geometry and banded sinc-resample weights and starts padded to
        common shapes (host-side NumPy, then on the device). Returns
        (rates, frames_out, len_stretch, zero_shift, W, start, FO_max,
        pad_left, Lbuf)."""
        plan = self._ta_plans.get(Tb)
        if plan is not None:
            return plan
        sub_sr = self.sub_band_sample_rate
        M = self.n_band
        frames = S.frame_count(Tb, self._n_fft, self._hop)
        rates, fo, ls, zero, banded = [], [], [], [], []
        for sh in self.pitch_shifters:
            if sh.n_steps == 0:  # identity early-out, torchaudio-style
                rates.append(1.0)
                fo.append(frames)
                ls.append(Tb)
                zero.append(1.0)
                banded.append((np.zeros((Tb, 1), np.float32),
                               np.zeros((Tb,), np.int32), 0))
                continue
            _, fo_b, ls_b, orig_b = sh.geometry(Tb)
            Wb, st, wd = _banded_plan(orig_b, sub_sr, Tb)
            g = math.gcd(orig_b, sub_sr)
            # torchaudio's target length ceil(T*new/orig); rows past it
            # are the shifter's right zero-pad
            valid = int(math.ceil(ls_b * (sub_sr // g) / (orig_b // g)))
            Wb = Wb.copy()
            Wb[min(valid, Tb):] = 0.0
            rates.append(sh.rate)
            fo.append(fo_b)
            ls.append(ls_b)
            zero.append(0.0)
            banded.append((Wb, st, wd))
        FO_max = max(fo)
        Kt = max(w.shape[-1] for w, _, _ in banded)
        pad_left = max(wd for _, _, wd in banded)
        W = np.zeros((M, Tb, Kt), np.float32)
        starts = np.zeros((M, Tb), np.int64)
        for i, (Wb, st, _) in enumerate(banded):
            W[i, :, : Wb.shape[-1]] = Wb
            starts[i] = st + pad_left
        ystr_len = self._n_fft // 2 + (FO_max - 1) * self._hop
        Lbuf = max(pad_left + ystr_len, int(starts.max()) + Kt)
        dev = self.device
        plan = (torch.tensor(np.asarray(rates, np.float32), device=dev),
                torch.tensor(fo, dtype=torch.int64, device=dev),
                torch.tensor(ls, dtype=torch.int64, device=dev),
                torch.tensor(zero, dtype=torch.float32, device=dev),
                torch.from_numpy(W).to(dev), torch.from_numpy(starts).to(dev),
                FO_max, pad_left, Lbuf)
        self._ta_plans[Tb] = plan
        return plan

    def pitchshifter(self, x):
        """Decompose (K1) -> shift all bands -> reconstruct (K2): x
        [1, T] / [B, 1, T] -> [B, 1, T]. ``pqmf.forward`` / ``inverse`` are
        the offline ``_cached_analysis`` / ``_cached_synthesis`` (a
        passthrough at n_band == 1, reference pqmf.py:250-251) on the bank
        installed at the time of the call. A CUDA graph per (B, T) on the
        card."""
        x = self._block(x)
        key = ("pitchshifter", x.shape[0], x.shape[-1], self.precision,
               self.device, self.pqmf.weights_version)
        lay = self.pqmf._layout
        if lay is None:
            return graphs.call(self._graphs, key, self._pitchshifter_eager,
                               x)
        y = graphs.call(self._graphs, key, self._pitchshifter_eager,
                        lay.local(x, data_dim=0), group=lay.group)
        return lay.wrap(y, data_dim=0, batch=x.shape[0])

    def _pitchshifter_eager(self, x):
        """K1, the shift of this rank's bands (all of them without a mesh)
        and K2 (then the band sum) over this rank's rows."""
        x = self._block(x)
        plan = self._ta_plan(x.shape[-1] // self.n_band)
        sl = self.pqmf.band_slice
        plan = tuple(a[sl] for a in plan[:6]) + plan[6:]
        shifted = _fused_ta_pitchshift(self.pqmf._forward_local(x), plan,
                                       self._n_fft, self._hop, self._win,
                                       self.precision)
        return self.pqmf._inverse_local(shifted)

    def pitchshifter_loop(self, x):
        """The reference's per-band dispatch structure, kept as the fused
        path's parity oracle (PQMFPsWrapper.py:114-150)."""
        subbands = self.forward(x)  # [B, M, Tb]
        if self.pqmf._layout is not None:  # the oracle runs every band
            subbands = subbands.full_tensor()
        target = subbands.shape[-1]
        out = []
        for i in range(self.n_band):
            shifted = self.pitch_shifters[i](subbands[:, i, :])[:, None, :]
            cur = shifted.shape[-1]
            if cur > target:
                start = (cur - target) // 2
                shifted = shifted[..., start:start + target]
            elif cur < target:
                # the reference pads with reflect here (PQMFPsWrapper.py:142)
                pad = target - cur
                shifted = S.reflect_pad(shifted, pad // 2, pad - pad // 2)
            out.append(shifted)
        return self.inverse(torch.cat(out, dim=1))

    __call__ = forward


@functools.lru_cache(maxsize=128)
def _banded_plan(orig_freq: int, new_freq: int, n_out: int):
    """:func:`~pqmf_tpu_torch.ops.resample.banded_resample_plan`, cached:
    a large reduced ratio takes the host about half a second, and wrappers
    of one configuration share their plans. The arrays are read-only."""
    plan = rs.banded_resample_plan(orig_freq, new_freq, n_out)
    for a in plan[:2]:
        a.setflags(write=False)
    return plan
