"""The flagship pitch shifter's middle as three kernels around two DFT
products, their plain versions and the stretch plan.

Between K1's sub-bands and K2's synthesis, ``PQMFPitchShiftWrapper`` runs
(``pipelines._fused_band_pitchshift``)::

    frame (pv_frame_kernel)         sub [B, Mb, Tb] -> frames [Mb*B, n, n_fft]
    STFT product (dft_matmul)       frames @ [C | S] -> spec [Mb*B, n, 2F]
    spectral (pv_spectral_kernel)   spec -> rows [B * sum(fo), 2F]
    ISTFT product (dft_matmul)      rows @ [Ci ; Si] -> prod [B * sum(fo), n_fft]
    resynth (pv_resynth_kernel)     prod -> shifted [B, Mb, Tb], new tail

with F = n_fft/2 + 1 bins and ``fo[m]`` output frames in band m. ``rows``
holds only the frames that exist, band-major, then stream, then frame: the
inverse DFT is one dense product, and no padded frame is computed. The
products stay ``torch.matmul`` at the configuration's tier
(``ops.stft.dft_matmul``); the three stages are the hand-written kernels of
``csrc/middle.cu`` on a CUDA device (what bounds them and their design is
written at the top of that source) and their plain PyTorch versions
(``*_plain``: the plain path's ops, in the same order) on the CPU.

Each stage is an operator of the ``pqmf_tpu_torch`` namespace
(``pv_frame``, ``pv_spectral``, ``pv_resynth``), like the conv kernels
(``cached_conv``): the CUDA impl launches the kernel or raises, the CPU impl
runs the plain version, the fake impl gives the output's shape to
``torch.export``. Every launch adds one to :data:`LAUNCHES`.

:func:`plan` is the static part, built once per wrapper, block length and
band slice: each band's rate and output frames, its first row in ``rows``,
the centre-fit span and stretched length of its overlap-add buffer, and the
window-square sums that the overlap-add divides by (they depend only on a
band's frame count).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.ops import phase_vocoder as pv
from pqmf_tpu_torch.ops import resample as rs
from pqmf_tpu_torch.ops import stft as S

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "Plan",
    "plan",
    "bases",
    "frame",
    "spectral",
    "resynth",
    "frame_plain",
    "spectral_plain",
    "resynth_plain",
    "OPS",
]

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"frame": 0, "spectral": 0, "resynth": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the columns of Plan.table (kPlanCols in csrc/middle.cu)
FO, ROW, LO, HI, LEN = range(5)

# crossfade modes of the resynth: none, the reference's one shared tail
# (B == 1), a tail a stream
NO_FADE, SHARED_FADE, STREAM_FADE = 0, 1, 2


class Plan(NamedTuple):
    """The static stretch plan of one (geometry, block length, band
    slice). ``table`` [Mb, 5] int32, one row a band: output frames, first
    row in the compact matrix of one stream (times B there), the centre-fit
    span [lo, hi) and the stretched length ``(fo-1)*hop + n_fft``;
    ``wsq`` [Mb, Tw]: each band's window-square sum over the overlap-add
    buffer of the band with the most frames (Tw samples), 1 where it is not
    above 1e-11."""

    n_fft: int
    hop: int
    win: int
    Tb: int
    frames: int     # STFT frames of a band
    fo: tuple       # output frames of each band
    table: torch.Tensor
    rates: torch.Tensor
    omega: torch.Tensor
    window: torch.Tensor  # Hann(win) centre-padded to n_fft
    wsq: torch.Tensor

    @property
    def rows(self) -> int:
        """Compact rows of one stream: every band's output frames."""
        return sum(self.fo)


def plan(rates, n_fft: int, hop: int, win: int, Tb: int, device) -> Plan:
    """The plan of bands stretched at ``rates`` (Python floats, the
    reference's per-band ``1 / 2**(shift/12)``) over blocks of ``Tb``
    samples a band. A band has ``max(1, floor(frames / rate))`` output
    frames, where ``frames`` counts the STFT frames of the block padded to
    at least ``n_fft``."""
    frames = S.frame_count(max(Tb, n_fft), n_fft, hop)
    fo = [max(1, int(math.floor(frames / r))) for r in rates]
    first = np.concatenate([[0], np.cumsum(fo)[:-1]])
    trim = n_fft // 2
    table = np.array([[f, r, trim, trim + (f - 1) * hop, (f - 1) * hop + n_fft]
                      for f, r in zip(fo, first)], np.int32)
    window = S._padded_window(S.hann_window(win), n_fft)
    # the plain overlap-add of the window's square over each band's frames,
    # summed on the host: in the same order on every device (a card's
    # index_add, where hop does not divide n_fft, adds in any order)
    n_fo = max(fo)
    fmask = (torch.arange(n_fo)[None, :]
             < torch.tensor(fo)[:, None]).to(torch.float32)
    wsq = S._ola((window * window).expand(n_fo, n_fft) * fmask[..., None],
                 n_fft, hop)
    wsq = torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    return Plan(n_fft, hop, win, Tb, frames, tuple(fo),
                torch.from_numpy(table).to(device),
                torch.tensor(list(rates), dtype=torch.float32, device=device),
                pv.phase_advance_reference(n_fft // 2 + 1, hop, n_fft,
                                           device=device),
                window.contiguous().to(device), wsq.contiguous().to(device))


@functools.lru_cache(maxsize=32)
def bases(n_fft: int, device) -> tuple:
    """The two products' right operands: the STFT's ``[C | S]`` [n_fft, 2F]
    (``ops.stft.stft_ri``'s) and the ISTFT's ``[Ci ; Si]`` [2F, n_fft]
    (``ops.stft.istft_ri_parts``'), built once per device. Callers must not
    write to them."""
    C, Sb = S.dft_basis(n_fft, device=device)
    Ci, Si = S.idft_basis(n_fft, device=device)
    return torch.cat([C, Sb], dim=1), torch.cat([Ci, Si], dim=0)


# ---------------------------------------------------------------------------
# the plain versions: the plain path's torch ops, rearranged into the
# three stages (CPU tensors only)
# ---------------------------------------------------------------------------


def frame_plain(sub, window, n_fft: int, hop: int, frames: int):
    """sub [B, Mb, Tb] -> windowed frames [Mb*B, frames, n_fft] (band-major
    rows, right pad to n_fft, centre pad of n_fft/2 zeros)."""
    B, M, Tb = sub.shape
    x = sub.transpose(0, 1).reshape(M * B, Tb)
    if Tb < n_fft:  # the reference pads short sub-bands right to n_fft
        x = F.pad(x, (0, n_fft - Tb))
    x = F.pad(x, (n_fft // 2, n_fft // 2))
    return S._frame_signal(x, n_fft, hop, frames) * window


def _keep(fo, B: int, n_fo: int):
    """[Mb, B, n_fo] bool: the frames that exist."""
    k = torch.arange(n_fo, device=fo.device)[None, :] < fo[:, None]
    return k[:, None, :].expand(fo.shape[0], B, n_fo)


def spectral_plain(spec, rates, table, omega, B: int, n_fft: int,
                   accumulate: bool):
    """spec [Mb*B, frames, 2F] (the STFT product: [re | -im], unscaled) ->
    rows [B * sum(fo), 2F] of the stretched ``[re | im]``, band-major, then
    stream, then frame, the frames that exist only."""
    MB, frames, _ = spec.shape
    M, F_ = MB // B, n_fft // 2 + 1
    f32 = torch.float32
    fo = table[:, FO].long()
    n_fo = int(fo.max())
    both = spec.transpose(1, 2)  # [Mb*B, 2F, frames]
    re, im = both[:, :F_], -both[:, F_:]
    scale = float(1.0 / np.sqrt(n_fft))
    re = (re * scale).reshape(M, B, F_, frames)
    im = (im * scale).reshape(M, B, F_, frames)

    mag = torch.sqrt(re * re + im * im + 1e-12)
    phase = torch.atan2(im, re)
    j = torch.arange(n_fo, dtype=f32, device=spec.device)
    t_prime = j[None, :] * rates[:, None]  # [M, FO]
    t0 = torch.floor(t_prime).to(torch.int64).clamp(0, frames - 1)
    t1 = (t0 + 1).clamp_max(frames - 1)
    a = (t_prime - t0.to(f32))[:, None, None, :]  # [M, 1, 1, FO]
    mag0, phi0 = pv._select_frames(mag, phase, t0)
    mag1, phi1 = pv._select_frames(mag, phase, t1)
    mag_s = (1 - a) * mag0 + a * mag1
    om = omega[None, None, :, None]
    dp = pv.principal_angle(phi1 - phi0 - om)
    if accumulate:
        # librosa/torchaudio running phase: accumulate wrapped advances,
        # summed in frame order in double (as the CPU sums a float cumsum)
        incs = torch.cat([phi0[..., :1], (dp + om)[..., :-1]], dim=-1)
        phi = torch.cumsum(incs.double(), dim=-1).to(f32)
    else:  # the reference's per-frame-independent rule
        phi = phi0 + om + a * dp
    re_s = mag_s * torch.cos(phi)
    im_s = mag_s * torch.sin(phi)
    ri = torch.cat([re_s, im_s], dim=2).transpose(2, 3)  # [M, B, FO, 2F]
    return ri[_keep(fo, B, n_fo)]


def resynth_plain(prod, table, wsq, window, prev_tail, fade_out, fade_in,
                  B: int, Tb: int, n_fft: int, hop: int, win: int,
                  mode: int):
    """prod [B * sum(fo), n_fft] (the ISTFT product of ``rows``) ->
    (shifted [B, Mb, Tb], the new tail: [Mb, L] in mode 1 (B == 1),
    [B, Mb, L] in mode 2, empty in mode 0). ``prev_tail`` is laid out as
    the new tail."""
    M = table.shape[0]
    f32 = torch.float32
    fo = table[:, FO].long()
    n_fo = int(fo.max())
    keep = _keep(fo, B, n_fo)

    # masked OLA ISTFT of each band over its whole (untrimmed) buffer
    y_f = prod.new_zeros((M, B, n_fo, n_fft))
    y_f[keep] = prod * float(np.sqrt(n_fft)) * window
    ola = S._ola(y_f, n_fft, hop) / wsq[:, None, :]  # [M, B, Tw]
    i = torch.arange(ola.shape[-1], device=prod.device)[None, :]
    # the centre fit of the istft output (length (fo-1)*hop) into the
    # stretched length (fo-1)*hop + n_fft: a pure mask
    valid = (i >= table[:, LO:LO + 1]) & (i < table[:, HI:HI + 1])
    p_multi = ola * valid[:, None, :].to(f32)

    # the reference's 1-frame fallback: the direct (normalized-in,
    # unscaled-out) irfft of frame 0, cropped to win, centred in n_fft
    first = B * table[:, ROW].long()[:, None] + (
        torch.arange(B, device=prod.device)[None, :] * fo[:, None])
    y1 = prod[first]  # [M, B, n_fft]
    one_off = (n_fft - win) // 2
    p_one = torch.zeros_like(ola)
    p_one[..., one_off:one_off + win] = y1[..., :win]
    P = torch.where((fo == 1)[:, None, None], p_one, p_multi)

    # per-band resample back to Tb from each band's stretched length
    shifted = rs.interpolate_linear_dynamic(P, table[:, LEN:LEN + 1].long(),
                                            Tb)  # [M, B, Tb]
    if mode == NO_FADE:
        return shifted.transpose(0, 1).contiguous(), prod.new_empty((0,))
    L = fade_out.shape[-1]
    if mode == STREAM_FADE:
        # per-stream tails [B, M, L]: every stream crossfades independently
        blended = (prev_tail.transpose(0, 1) * fade_out
                   + shifted[:, :, :L] * fade_in)
        new_tail = shifted[:, :, Tb - L:].transpose(0, 1).contiguous()
        shifted = torch.cat([blended, shifted[:, :, L:]], dim=-1)
    else:  # the reference: a single shared tail, batch == 1
        blended = prev_tail * fade_out + shifted[:, 0, :L] * fade_in
        new_tail = shifted[:, 0, Tb - L:].contiguous()
        shifted = torch.cat([blended[:, None], shifted[:, :, L:]], dim=-1)
    return shifted.transpose(0, 1).contiguous(), new_tail


def _spectral_ulps(got, want, p: Plan, accumulate: bool):
    """Two spectral stages' outputs (``rows``) compared bin by bin as
    magnitude and phase: (the magnitudes' difference in f32 ulps of the
    magnitude, the wrapped phases' difference in f32 ulps of the largest
    phase the rule reaches in that bin), each [rows, F]. The largest phase
    is ``2 pi + omega`` (reference) or ``pi + max(fo) (pi + omega)``
    (accumulate): a phase is rounded at that size, so an ulp upstream moves
    it by about an ulp there. A phase-rule branch that falls the other way
    moves the phase by ``a * 2 pi``: thousands of such ulps. The tests'
    comparison, not part of the stages."""
    F_ = p.n_fft // 2 + 1
    g, w = got.double(), want.double()
    mg, mw = g[:, :F_].hypot(g[:, F_:]), w[:, :F_].hypot(w[:, F_:])
    d = torch.remainder(torch.atan2(g[:, F_:], g[:, :F_])
                        - torch.atan2(w[:, F_:], w[:, :F_]) + math.pi,
                        2 * math.pi) - math.pi
    om = p.omega.double()
    reach = (math.pi + max(p.fo) * (math.pi + om) if accumulate
             else 2 * math.pi + om)
    eps = torch.finfo(torch.float32).eps
    return ((mg - mw).abs() / (eps * mw.clamp_min(1e-30)),
            d.abs() / (eps * reach))


# ---------------------------------------------------------------------------
# the stages as operators: CUDA launches the kernel, CPU runs the plain
# version, fake gives the shapes
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("pqmf_tpu_torch", "FRAGMENT")
_LIB.define("pv_frame(Tensor sub, Tensor window, int n_fft, int hop, "
            "int frames) -> Tensor")
_LIB.define("pv_spectral(Tensor spec, Tensor rates, Tensor table, "
            "Tensor omega, int B, int n_fft, int[] fo, bool accumulate) "
            "-> Tensor")
_LIB.define("pv_resynth(Tensor prod, Tensor table, Tensor wsq, "
            "Tensor window, Tensor prev_tail, Tensor? fade_out, "
            "Tensor? fade_in, int B, int Tb, int n_fft, int hop, int win, "
            "int[] fo, int mode) -> (Tensor, Tensor)")
OPS = torch.ops.pqmf_tpu_torch


def _tail_shape(B: int, M: int, L: int, mode: int) -> tuple:
    return {NO_FADE: (0,), SHARED_FADE: (M, L), STREAM_FADE: (B, M, L)}[mode]


def _check(dev, **shapes):
    """Each operand the kernels read: contiguous float32 (the plan table
    int32) on the call's device, of the shape the geometry gives it."""
    for name, (t, shape) in shapes.items():
        want = torch.int32 if name == "table" else torch.float32
        if (t.dtype != want or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(
                f"{name} must be contiguous {want} {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} "
                f"{'' if t.is_contiguous() else 'strided '}on {t.device}")


def _frame_operands(sub, window, n_fft, hop, frames):
    if sub.ndim != 3 or n_fft % 4 or hop < 1 or frames < 1:
        raise ValueError(f"framing [B, Mb, Tb] by n_fft % 4 == 0, hop >= 1: "
                         f"got {tuple(sub.shape)}, {n_fft}, {hop}, {frames}")
    _check(sub.device, sub=(sub, sub.shape), window=(window, (n_fft,)))


def _spectral_operands(spec, rates, table, omega, B, n_fft, fo):
    M = len(fo)
    F_ = n_fft // 2 + 1
    if spec.ndim != 3:
        raise ValueError(f"spec must be [Mb*B, frames, 2F], got "
                         f"{tuple(spec.shape)}")
    _check(spec.device, spec=(spec, (M * B, spec.shape[1], 2 * F_)),
           rates=(rates, (M,)), table=(table, (M, 5)), omega=(omega, (F_,)))


def _resynth_operands(prod, table, wsq, window, prev_tail, fade_out, fade_in,
                      B, Tb, n_fft, hop, fo, mode):
    M = len(fo)
    dev = prod.device
    _check(dev, prod=(prod, (B * sum(fo), n_fft)), table=(table, (M, 5)),
           wsq=(wsq, (M, n_fft + (max(fo) - 1) * hop)),
           window=(window, (n_fft,)))
    if mode == NO_FADE:
        return
    L = fade_out.shape[-1]
    if Tb < L or (mode == SHARED_FADE and B != 1):
        raise ValueError(f"the crossfade must be over Tb >= L, a shared "
                         f"tail over B == 1: got Tb {Tb}, L {L}, B {B}")
    _check(dev, fade_out=(fade_out, (L,)), fade_in=(fade_in, (L,)),
           prev_tail=(prev_tail, _tail_shape(B, M, L, mode)))


def _launch(fn, *args):
    from pqmf_tpu_torch.kernels.cached_conv import _launch as launch

    with torch.cuda.device(args[0].device):
        launch(fn, *(a.data_ptr() if isinstance(a, torch.Tensor) else a
                     for a in args))


def _frame_cuda(sub, window, n_fft, hop, frames):
    _frame_operands(sub, window, n_fft, hop, frames)
    B, M, Tb = sub.shape
    out = torch.empty((M * B, frames, n_fft), dtype=torch.float32,
                      device=sub.device)
    _launch("pqmf_pv_frame", sub, window, out, B, M, Tb, n_fft, hop, frames)
    LAUNCHES["frame"] += 1
    return out


def _spectral_cuda(spec, rates, table, omega, B, n_fft, fo, accumulate):
    _spectral_operands(spec, rates, table, omega, B, n_fft, fo)
    out = torch.empty((B * sum(fo), n_fft + 2), dtype=torch.float32,
                      device=spec.device)
    _launch("pqmf_pv_spectral", spec, rates, table, omega, out, B, len(fo),
            n_fft, spec.shape[1], ctypes.c_float(1.0 / np.sqrt(n_fft)),
            int(accumulate))
    LAUNCHES["spectral"] += 1
    return out


def _resynth_cuda(prod, table, wsq, window, prev_tail, fade_out, fade_in, B,
                  Tb, n_fft, hop, win, fo, mode):
    _resynth_operands(prod, table, wsq, window, prev_tail, fade_out, fade_in,
                      B, Tb, n_fft, hop, fo, mode)
    M = len(fo)
    L = fade_out.shape[-1] if mode != NO_FADE else 0
    out = torch.empty((B, M, Tb), dtype=torch.float32, device=prod.device)
    tail = torch.empty(_tail_shape(B, M, L, mode), dtype=torch.float32,
                       device=prod.device)
    _launch("pqmf_pv_resynth", prod, table, wsq, window, prev_tail, fade_out,
            fade_in, out, tail, B, M, Tb, n_fft, hop, win, wsq.shape[-1], L,
            mode, ctypes.c_float(np.sqrt(n_fft)))
    LAUNCHES["resynth"] += 1
    return out, tail


def _frame_cpu(sub, window, n_fft, hop, frames):
    _frame_operands(sub, window, n_fft, hop, frames)
    return frame_plain(sub, window, n_fft, hop, frames)


def _spectral_cpu(spec, rates, table, omega, B, n_fft, fo, accumulate):
    _spectral_operands(spec, rates, table, omega, B, n_fft, fo)
    return spectral_plain(spec, rates, table, omega, B, n_fft, accumulate)


def _resynth_cpu(prod, table, wsq, window, prev_tail, fade_out, fade_in, B,
                 Tb, n_fft, hop, win, fo, mode):
    _resynth_operands(prod, table, wsq, window, prev_tail, fade_out, fade_in,
                      B, Tb, n_fft, hop, fo, mode)
    return resynth_plain(prod, table, wsq, window, prev_tail, fade_out,
                         fade_in, B, Tb, n_fft, hop, win, mode)


for _name, _cuda, _cpu in [("pv_frame", _frame_cuda, _frame_cpu),
                           ("pv_spectral", _spectral_cuda, _spectral_cpu),
                           ("pv_resynth", _resynth_cuda, _resynth_cpu)]:
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")


@torch.library.register_fake("pqmf_tpu_torch::pv_frame", lib=_LIB)
def _frame_fake(sub, window, n_fft, hop, frames):
    return sub.new_empty((sub.shape[1] * sub.shape[0], frames, n_fft))


@torch.library.register_fake("pqmf_tpu_torch::pv_spectral", lib=_LIB)
def _spectral_fake(spec, rates, table, omega, B, n_fft, fo, accumulate):
    return spec.new_empty((B * sum(fo), n_fft + 2))


@torch.library.register_fake("pqmf_tpu_torch::pv_resynth", lib=_LIB)
def _resynth_fake(prod, table, wsq, window, prev_tail, fade_out, fade_in, B,
                  Tb, n_fft, hop, win, fo, mode):
    L = fade_out.shape[-1] if mode != NO_FADE else 0
    return (prod.new_empty((B, len(fo), Tb)),
            prod.new_empty(_tail_shape(B, len(fo), L, mode)))


# ---------------------------------------------------------------------------
# the stages as the pipeline calls them
# ---------------------------------------------------------------------------


def frame(sub, p: Plan):
    """Stage 1: sub [B, Mb, Tb] -> the STFT's windowed frames
    [Mb*B, frames, n_fft]."""
    return OPS.pv_frame.default(sub.contiguous(), p.window, p.n_fft, p.hop,
                                p.frames)


def spectral(spec, p: Plan, B: int, accumulate: bool):
    """Stage 2: the STFT product [Mb*B, frames, 2F] -> the ISTFT's operand
    [B * sum(fo), 2F]."""
    return OPS.pv_spectral.default(spec, p.rates, p.table, p.omega, B,
                                   p.n_fft, list(p.fo), bool(accumulate))


def resynth(prod, p: Plan, B: int, prev_tail, fade_out, fade_in, mode: int):
    """Stage 3: the ISTFT product [B * sum(fo), n_fft] -> (shifted
    [B, Mb, Tb], the new tail as :func:`resynth_plain` returns it);
    ``prev_tail`` [Mb, L] (mode 1) or [B, Mb, L] (mode 2)."""
    return OPS.pv_resynth.default(prod, p.table, p.wsq, p.window,
                                  prev_tail.contiguous(),
                                  fade_out, fade_in, B, p.Tb, p.n_fft, p.hop,
                                  p.win, list(p.fo), mode)
