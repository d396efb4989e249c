"""The flagship's middle as three stages (``kernels/middle.py``) on the CPU.

- The stretch plan and the three plain stage functions against the middle
  written op by op over bands padded to the most output frames and masked
  (``_op_by_op`` below: the layout the stages replace), intermediate by
  intermediate: bit for bit, except where the stages compute another
  rounding by design (the inverse DFT as one dense product over the frames
  that exist; a band of one frame reading its product row instead of two
  products of its own).
- The CUDA source ``csrc/middle.cu`` itself, built with g++ against a small
  emulated runtime (one CPU thread walks every CUDA thread), against the
  plain stages: the frames and the resynthesis bit for bit (both are
  elementwise f32 arithmetic in the plain order), the spectral stage within
  a few f32 ulps (the C library's atan2f / sinf / cosf against PyTorch's)
  and with no phase-rule branch flipped.
- On the CPU no kernel launches, and the operators' fake (shape)
  implementations agree with their CPU ones.

No JAX: the JAX package's parity lives in ``test_torch_pipeline.py``.
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pqmf_tpu_torch import PQMFPitchShiftWrapper, stream_ola
from pqmf_tpu_torch.kernels import middle as pm
from pqmf_tpu_torch.ops import phase_vocoder as pv
from pqmf_tpu_torch.ops import resample as rs
from pqmf_tpu_torch.ops import stft as S

# (n_band, m_buffer_size, block, shifts): the flagship's default; a
# short-band geometry whose blocks of 256 are shorter than n_fft (Tb = 16
# against 64) with bands of one frame (rates over the frame count); a
# hop that does not divide n_fft (188 / 47 / 256: the overlap-add's
# general order); n_fft 1024 with one band of one frame
GEOMETRIES = {
    "16x8192": (16, 8192, 8192, None),
    "8x2048": (8, 2048, 2048, [0, -48, 5, -40, 12, -36, 3, 7]),
    "16x1024_short": (16, 1024, 256, [-48] * 4 + [3, -2, 0, 1] * 3),
    "16x3008_odd_hop": (16, 3008, 3008, None),
    "4x4096": (4, 4096, 4096, [-50, 7, -3, 1]),
}


def _wrapper(geometry, phase_rule="reference", precision="highest"):
    M, buf, _, shifts = GEOMETRIES[geometry]
    return PQMFPitchShiftWrapper(100, M, buf, shifts_in_semitones=shifts,
                                 phase_rule=phase_rule, precision=precision,
                                 device="cpu")


def _bands(geometry, B, seed):
    M, _, block, _ = GEOMETRIES[geometry]
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, M, block // M, generator=g) * 0.3


def _op_by_op(w, bands, prev_tail, crossfade):
    """The middle as plain torch ops over every band padded to the most
    output frames and masked, each intermediate by name."""
    B, M, Tb = bands.shape
    n_fft, hop, win, prec = w.n_fft, w.hop, w.win, w.precision
    f32 = torch.float32
    frames = S.frame_count(max(Tb, n_fft), n_fft, hop)
    fo_list = [max(1, int(math.floor(frames / r))) for r in w._rates_py]
    frames_out, FO_max = torch.tensor(fo_list), max(fo_list)
    rates = w._rates
    window = S.hann_window(win)
    out = {"fo": fo_list, "frames": frames}

    x = bands.transpose(0, 1).reshape(M * B, Tb)
    if Tb < n_fft:
        x = F.pad(x, (0, n_fft - Tb))
    out["framed"] = S._framed(x, n_fft, hop, window, True, "constant")
    re, im = S.stft_ri(x, n_fft, hop, window, normalized=True,
                       precision=prec)
    F_ = re.shape[1]
    re, im = re.reshape(M, B, F_, frames), im.reshape(M, B, F_, frames)
    omega = pv.phase_advance_reference(F_, hop, n_fft)
    mag = torch.sqrt(re * re + im * im + 1e-12)
    phase = torch.atan2(im, re)
    j = torch.arange(FO_max, dtype=f32)
    t_prime = j[None, :] * rates[:, None]
    t0 = torch.floor(t_prime).to(torch.int64).clamp(0, frames - 1)
    t1 = (t0 + 1).clamp_max(frames - 1)
    a = (t_prime - t0.to(f32))[:, None, None, :]
    mag0, phi0 = pv._select_frames(mag, phase, t0)
    mag1, phi1 = pv._select_frames(mag, phase, t1)
    mag_s = (1 - a) * mag0 + a * mag1
    om = omega[None, None, :, None]
    dp = pv.principal_angle(phi1 - phi0 - om)
    if w.phase_rule == "accumulate":
        incs = torch.cat([phi0[..., :1], (dp + om)[..., :-1]], dim=-1)
        phi = torch.cumsum(incs, dim=-1)
    else:
        phi = phi0 + om + a * dp
    fmask = (torch.arange(FO_max)[None, :] < frames_out[:, None]).to(f32)
    fm = fmask[:, None, None, :]
    re_s = mag_s * torch.cos(phi) * fm
    im_s = mag_s * torch.sin(phi) * fm
    out["ri"] = torch.cat([re_s, im_s], dim=2).transpose(2, 3)
    Ci, Si = S.idft_basis(n_fft)
    out["prod"] = S.dft_matmul(out["ri"], torch.cat([Ci, Si], dim=0), prec)

    y, wsq = S.istft_ri_parts(re_s, im_s, n_fft, hop, window,
                              normalized=True, frame_mask=fmask[:, None, :],
                              precision=prec)
    out["wsq"] = torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))[:, 0]
    ola = y / out["wsq"][:, None]
    i = torch.arange(ola.shape[-1])[None, :]
    trim, fo = n_fft // 2, frames_out[:, None]
    out["valid"] = (i >= trim) & (i < trim + (fo - 1) * hop)
    p_multi = ola * out["valid"][:, None, :].to(f32)
    y1 = (S.dft_matmul(re_s[..., 0], Ci, prec)
          + S.dft_matmul(im_s[..., 0], Si, prec))
    one_off = (n_fft - win) // 2
    p_one = torch.zeros_like(ola)
    p_one[..., one_off:one_off + win] = y1[..., :win]
    P = torch.where((frames_out == 1)[:, None, None], p_one, p_multi)
    out["length"] = ((frames_out - 1) * hop + n_fft).clamp_min(1)
    shifted = rs.interpolate_linear_dynamic(P, out["length"][:, None], Tb)

    L = prev_tail.shape[-1]
    if crossfade == "batched":  # the streams' tails [B, M, L]
        blended = (prev_tail.transpose(0, 1) * w._fade_out
                   + shifted[:, :, :L] * w._fade_in)
        new_tail = shifted[:, :, Tb - L:].transpose(0, 1).contiguous()
        shifted = torch.cat([blended, shifted[:, :, L:]], dim=-1)
    elif crossfade is True and B == 1:
        blended = prev_tail * w._fade_out + shifted[:, 0, :L] * w._fade_in
        new_tail = shifted[:, 0, Tb - L:].contiguous()
        shifted = torch.cat([blended[:, None], shifted[:, :, L:]], dim=-1)
    else:
        new_tail = prev_tail
    out["shifted"], out["tail"] = shifted.transpose(0, 1), new_tail
    return out


def _tail(w, B, crossfade, seed=9):
    """The carried tail as the step's state holds it."""
    g = torch.Generator().manual_seed(seed)
    shape = ((B, w.n_band, w.band_overlap) if crossfade == "batched"
             else (w.n_band, w.band_overlap))
    return torch.randn(shape, generator=g) * 0.1


def _mode(crossfade, B):
    if crossfade == "batched":
        return pm.STREAM_FADE
    return pm.SHARED_FADE if crossfade is True and B == 1 else pm.NO_FADE


def _stage_inputs(w, bands, accumulate=None):
    """The plan and each stage's output of the plain path."""
    B, _, Tb = bands.shape
    p = w._plan(Tb)
    acc = w.phase_rule == "accumulate" if accumulate is None else accumulate
    stft_basis, istft_basis = pm.bases(p.n_fft, bands.device)
    frames = pm.frame_plain(bands, p.window, p.n_fft, p.hop, p.frames)
    spec = S.dft_matmul(frames, stft_basis, w.precision)
    rows = pm.spectral_plain(spec, p.rates, p.table, p.omega, B, p.n_fft,
                             acc)
    prod = S.dft_matmul(rows, istft_basis, w.precision)
    return p, frames, spec, rows, prod


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_plan_tables_equal_the_op_by_op_middle(geometry):
    """Frame counts, each band's first compact row, the centre-fit span,
    the stretched length and the window-square sums are the op-by-op
    middle's; the table's rows are what the kernels read."""
    w = _wrapper(geometry)
    bands = _bands(geometry, 1, 1)
    old = _op_by_op(w, bands, _tail(w, 1, False), False)
    p = w._plan(bands.shape[-1])
    assert p.fo == tuple(old["fo"]) and p.frames == old["frames"]
    t = p.table
    assert t.dtype == torch.int32 and t.shape == (w.n_band, 5)
    assert t[:, pm.FO].tolist() == old["fo"]
    assert t[:, pm.ROW].tolist() == [sum(old["fo"][:m])
                                     for m in range(w.n_band)]
    assert p.rows == sum(old["fo"])
    assert torch.equal(t[:, pm.LEN].long(), old["length"])
    i = torch.arange(old["valid"].shape[-1])[None, :]
    valid = (i >= t[:, pm.LO:pm.LO + 1]) & (i < t[:, pm.HI:pm.HI + 1])
    assert torch.equal(valid, old["valid"])
    assert p.wsq.shape[-1] == w.n_fft + (max(old["fo"]) - 1) * w.hop
    assert torch.equal(p.wsq, old["wsq"])
    assert torch.equal(p.rates, w._rates)
    assert torch.equal(p.window, S._padded_window(S.hann_window(w.win),
                                                  w.n_fft))


def test_plan_follows_the_band_slice():
    """A mesh rank's plan holds its bands' rows only, and is kept apart
    from the whole bank's in the wrapper's cache."""
    w = _wrapper("8x2048")
    full = w._plan(256)
    sl = slice(4, 8)
    part = pm.plan(w._rates_py[sl], w.n_fft, w.hop, w.win, 256, "cpu")
    assert part.fo == full.fo[sl]
    assert part.table[:, pm.ROW].tolist() == [0, part.fo[0],
                                              sum(part.fo[:2]),
                                              sum(part.fo[:3])]
    assert torch.equal(part.wsq, full.wsq[sl, :part.wsq.shape[-1]])
    assert set(w._plans) == {(256, None, None)}


@pytest.mark.parametrize("B,crossfade", [(1, True), (1, False), (3, True),
                                         (3, "batched")])
@pytest.mark.parametrize("phase_rule", ["reference", "accumulate"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_stages_equal_the_op_by_op_middle(geometry, phase_rule, B,
                                          crossfade):
    w = _wrapper(geometry, phase_rule)
    bands = _bands(geometry, B, 2 + B)
    prev = _tail(w, B, crossfade)
    old = _op_by_op(w, bands, prev, crossfade)
    p, frames, spec, rows, prod = _stage_inputs(w, bands)
    keep = pm._keep(torch.tensor(p.fo), B, max(p.fo))
    one = [m for m in range(w.n_band) if p.fo[m] == 1]
    many = [m for m in range(w.n_band) if p.fo[m] > 1]

    assert torch.equal(frames, old["framed"])
    # the spectrum at the frames that exist, in the compact order
    assert torch.equal(rows, old["ri"][keep])
    # one dense product against one product a band and stream: another
    # summation order where the layouts take other GEMM kernels
    torch.testing.assert_close(prod, old["prod"][keep], atol=1e-6, rtol=0)

    # the resynthesis of the op-by-op middle's own product rows
    shifted, tail = pm.resynth_plain(
        old["prod"][keep], p.table, p.wsq, p.window, prev, w._fade_out,
        w._fade_in, B, p.Tb, p.n_fft, p.hop, p.win, _mode(crossfade, B))
    assert shifted.is_contiguous()
    assert torch.equal(shifted[:, many], old["shifted"][:, many])
    # a band of one frame reads its product row, not two products
    torch.testing.assert_close(shifted[:, one], old["shifted"][:, one],
                               atol=1e-6, rtol=0)
    mode = _mode(crossfade, B)
    if mode == pm.NO_FADE:
        assert tail.numel() == 0
    else:
        assert tail.shape == old["tail"].shape
        torch.testing.assert_close(tail, old["tail"], atol=1e-6, rtol=0)
        assert torch.equal(tail[..., many, :], old["tail"][..., many, :])

    # the whole middle as the wrapper runs it
    got, new_tail = w._shift(bands, prev, crossfade)
    torch.testing.assert_close(got, old["shifted"], atol=2e-6, rtol=0)
    if mode == pm.NO_FADE:
        assert new_tail is prev
    else:
        assert new_tail.shape == prev.shape
        torch.testing.assert_close(new_tail, old["tail"], atol=2e-6, rtol=0)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_the_products_keep_their_tier(precision):
    """The stages change no product: at every tier the two products are
    ``dft_matmul`` at that tier, so the stages' middle equals the
    op-by-op middle's as closely at ``default`` (bf16 operands) as at
    ``highest``."""
    w = _wrapper("8x2048", precision=precision)
    bands = _bands("8x2048", 1, 4)
    prev = _tail(w, 1, True)
    old = _op_by_op(w, bands, prev, True)
    got, tail = w._shift(bands, prev, True)
    torch.testing.assert_close(got, old["shifted"], atol=2e-6, rtol=0)
    torch.testing.assert_close(tail, old["tail"], atol=2e-6, rtol=0)


def test_accumulate_sums_the_phase_in_double_in_frame_order():
    """The plain running phase is the f32 increments summed in frame order
    in double and rounded once a frame: what PyTorch's CPU cumsum of the
    f32 increments gives (it accumulates in double), and what the kernel
    computes."""
    g = torch.Generator().manual_seed(0)
    incs = torch.randn(64, 11, generator=g) * 400
    seq, acc = torch.empty_like(incs), torch.zeros(64, dtype=torch.float64)
    for j in range(11):
        acc = acc + incs[:, j].double()
        seq[:, j] = acc.float()
    assert torch.equal(torch.cumsum(incs, -1), seq)
    assert torch.equal(torch.cumsum(incs.double(), -1).float(), seq)


def test_cpu_tensors_launch_nothing():
    """Every flagship entry on the CPU runs the plain stages: no kernel
    launch is counted."""
    pm.reset_launches()
    w = _wrapper("16x1024_short")
    x = np.random.default_rng(3).standard_normal((1, 1024)).astype(
        np.float32) * 0.3
    w.pitchshift(x)
    w.pitchshift_fn(w.init_state(), np.repeat(x, 2, 0)[:, None, :])
    w.pitchshift_streams(w.init_streams(3), np.repeat(x, 3, 0))
    stream_ola(w, np.repeat(x, 2, -1), 512)
    assert pm.LAUNCHES == {"frame": 0, "spectral": 0, "resynth": 0}


@pytest.mark.parametrize("mode", [pm.NO_FADE, pm.SHARED_FADE,
                                  pm.STREAM_FADE])
def test_operators_fake_shapes_equal_the_cpu_impls(mode):
    """Under ``torch.export``'s fake tensors each operator gives the shape
    and strides its CPU impl returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    w = _wrapper("8x2048")
    B = 1 if mode == pm.SHARED_FADE else 2
    bands = _bands("8x2048", B, 5)
    crossfade = {pm.NO_FADE: False, pm.SHARED_FADE: True,
                 pm.STREAM_FADE: "batched"}[mode]
    prev = _tail(w, B, crossfade)
    p, frames, spec, rows, prod = _stage_inputs(w, bands)
    calls = [
        (pm.OPS.pv_frame.default, (bands, p.window, p.n_fft, p.hop,
                                   p.frames)),
        (pm.OPS.pv_spectral.default, (spec, p.rates, p.table, p.omega, B,
                                      p.n_fft, list(p.fo), False)),
        (pm.OPS.pv_resynth.default, (prod, p.table, p.wsq, p.window, prev,
                                     w._fade_out, w._fade_in, B, p.Tb,
                                     p.n_fft, p.hop, p.win, list(p.fo),
                                     mode))]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode_:
        fake = [op(*(mode_.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args)) for op, args in calls]
    real = [op(*args) for op, args in calls]
    for f, r in zip(fake, real):
        f, r = (f, r) if isinstance(r, tuple) else ((f,), (r,))
        for a, b in zip(f, r):
            assert a.shape == b.shape
            assert [s for s, n in zip(a.stride(), a.shape) if n > 1] == \
                [s for s, n in zip(b.stride(), b.shape) if n > 1]
    assert torch.equal(real[0], frames)
    assert torch.equal(real[1], rows)


@pytest.mark.parametrize("case", ["prod rows", "wsq length", "table int64",
                                  "spec bins", "tail shape", "window length",
                                  "sub strided"])
def test_operators_refuse_operands_the_kernels_do_not_take(case):
    """Every operand's dtype, device, contiguity and shape is checked in
    Python, on the CPU as on the card, before a pointer is taken: the
    kernels index rows, tables and tails by the plan's frame counts."""
    w = _wrapper("8x2048")
    B = 2
    bands = _bands("8x2048", B, 6)
    p, frames, spec, rows, prod = _stage_inputs(w, bands)
    prev = _tail(w, B, "batched")
    fo = list(p.fo)
    frame_args = [bands, p.window, p.n_fft, p.hop, p.frames]
    spectral_args = [spec, p.rates, p.table, p.omega, B, p.n_fft, fo, False]
    resynth_args = [prod, p.table, p.wsq, p.window, prev, w._fade_out,
                    w._fade_in, B, p.Tb, p.n_fft, p.hop, p.win, fo,
                    pm.STREAM_FADE]
    op, args, i, bad = {
        "prod rows": ("pv_resynth", resynth_args, 0, prod[:-1]),
        "wsq length": ("pv_resynth", resynth_args, 2, p.wsq[:, :-1]),
        "table int64": ("pv_spectral", spectral_args, 2, p.table.long()),
        "spec bins": ("pv_spectral", spectral_args, 0, spec[..., :-2]),
        "tail shape": ("pv_resynth", resynth_args, 4, prev[:, :1]),
        "window length": ("pv_frame", frame_args, 1, p.window[:-4]),
        "sub strided": ("pv_frame", frame_args, 0,
                        bands.transpose(0, 1).contiguous().transpose(0, 1)),
    }[case]
    getattr(pm.OPS, op).default(*args)  # the operands as the plan gives them
    args = list(args)
    args[i] = bad
    with pytest.raises(ValueError, match="must be"):
        getattr(pm.OPS, op).default(*args)


def test_a_shared_tail_takes_one_stream():
    """The reference's shared tail [Mb, L] crossfades a single stream: over
    B > 1 the resynthesis refuses it (the kernel writes a tail a stream,
    past the shared tail's end)."""
    w = _wrapper("8x2048")
    B = 2
    p, _, _, _, prod = _stage_inputs(w, _bands("8x2048", B, 6))
    with pytest.raises(ValueError, match="a shared tail over B == 1"):
        pm.OPS.pv_resynth.default(prod, p.table, p.wsq, p.window,
                                  _tail(w, 1, True), w._fade_out,
                                  w._fade_in, B, p.Tb, p.n_fft, p.hop, p.win,
                                  list(p.fo), pm.SHARED_FADE)


# ---------------------------------------------------------------------------
# csrc/middle.cu on the CPU
# ---------------------------------------------------------------------------

# What csrc/middle.cu uses of CUDA, for g++: one CPU thread walks every
# block and thread of a launch in turn (the kernels share nothing between
# threads), the explicitly rounded operations are the plain f32 ones (built
# with -ffp-contract=off, so nothing is fused), the math functions the C
# library's.
_EMU_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <math.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
inline uint3 threadIdx, blockIdx, blockDim, gridDim;
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
using std::max; using std::min;
inline cudaError_t cudaGetLastError() { return 0; }
template <typename K>
void emu_launch(long long grid, int block, size_t, cudaStream_t, K k) {
  gridDim = {(unsigned)grid, 1, 1};
  blockDim = {(unsigned)block, 1, 1};
  for (long long b = 0; b < grid; ++b)
    for (int t = 0; t < block; ++t) {
      blockIdx = {(unsigned)b, 0, 0};
      threadIdx = {(unsigned)t, 0, 0};
      k();
    }
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/middle.cu`` built with g++ against the emulated runtime, its C
    entries bound as the card's are."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated CUDA source")
    d = tmp_path_factory.mktemp("middle_emulated")
    (d / "cuda_runtime.h").write_text(_EMU_RUNTIME)
    src = (Path(pm.__file__).parent.parent / "csrc" / "middle.cu").read_text()
    src = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                 r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    (d / "k.cpp").write_text(src)
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-w", f"-I{d}", "-o", str(d / "k.so"),
                    str(d / "k.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pqmf_pv_frame.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.pqmf_pv_spectral.argtypes = [p] * 5 + [i] * 4 + [ctypes.c_float, i,
                                                          p]
    lib.pqmf_pv_resynth.argtypes = [p] * 9 + [i] * 9 + [ctypes.c_float, p]
    for fn in (lib.pqmf_pv_frame, lib.pqmf_pv_spectral, lib.pqmf_pv_resynth):
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _emu_frame(lib, sub, p):
    B, M, Tb = sub.shape
    out = torch.full((M * B, p.frames, p.n_fft), float("nan"))
    assert lib.pqmf_pv_frame(_ptr(sub), _ptr(p.window), _ptr(out), B, M, Tb,
                             p.n_fft, p.hop, p.frames, None) == 0
    return out


def _emu_spectral(lib, spec, p, B, accumulate):
    out = torch.full((B * p.rows, p.n_fft + 2), float("nan"))
    assert lib.pqmf_pv_spectral(
        _ptr(spec), _ptr(p.rates), _ptr(p.table), _ptr(p.omega), _ptr(out),
        B, p.table.shape[0], p.n_fft, spec.shape[1],
        float(1.0 / np.sqrt(p.n_fft)), int(accumulate), None) == 0
    return out


def _emu_resynth(lib, prod, p, B, prev, fade_out, fade_in, mode):
    M = p.table.shape[0]
    L = fade_out.shape[-1]
    out = torch.full((B, M, p.Tb), float("nan"))
    tail = torch.full(pm._tail_shape(B, M, L, mode), float("nan"))
    assert lib.pqmf_pv_resynth(
        _ptr(prod), _ptr(p.table), _ptr(p.wsq), _ptr(p.window), _ptr(prev),
        _ptr(fade_out), _ptr(fade_in), _ptr(out), _ptr(tail), B, M, p.Tb,
        p.n_fft, p.hop, p.win, p.wsq.shape[-1], L if mode else 0, mode,
        float(np.sqrt(p.n_fft)), None) == 0
    return out, tail


def test_emulation_binds_what_the_card_binds(emulated):
    """The emulated library's entries take the card binding's argument
    types (``kernels/_build._bind``)."""
    from pqmf_tpu_torch.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    bound = _build._bind(Lib())
    for name in ("pqmf_pv_frame", "pqmf_pv_spectral", "pqmf_pv_resynth"):
        assert getattr(bound, name).argtypes == getattr(emulated,
                                                        name).argtypes
        assert getattr(bound, name).restype == ctypes.c_int


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_emulated_frame_kernel_equals_plain(emulated, geometry, B):
    w = _wrapper(geometry)
    bands = _bands(geometry, B, 11)
    p = w._plan(bands.shape[-1])
    want = pm.frame_plain(bands, p.window, p.n_fft, p.hop, p.frames)
    assert torch.equal(_emu_frame(emulated, bands.contiguous(), p), want)


# the spectral stage against the plain one: the C library's atan2f / sinf /
# cosf against PyTorch's CPU kernels, one ulp of each (read 2.6 magnitude
# ulps and 1.1 phase ulps at most here)
MAG_ULPS, PHASE_ULPS = 8, 4


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("phase_rule", ["reference", "accumulate"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_emulated_spectral_kernel_equals_plain(emulated, geometry,
                                               phase_rule, B):
    w = _wrapper(geometry, phase_rule)
    bands = _bands(geometry, B, 12)
    p, _, spec, rows, _ = _stage_inputs(w, bands)
    accumulate = phase_rule == "accumulate"
    got = _emu_spectral(emulated, spec, p, B, accumulate)
    assert not got.isnan().any()  # every row of every frame written
    mag, phase = pm._spectral_ulps(got, rows, p, accumulate)
    assert mag.max() <= MAG_ULPS
    flips = (phase > PHASE_ULPS).sum().item()
    assert flips == 0, f"{flips} phases past {PHASE_ULPS} ulps"


@pytest.mark.parametrize("B,crossfade", [(1, True), (1, False), (3, False),
                                         (3, "batched")])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_emulated_resynth_kernel_equals_plain(emulated, geometry, B,
                                              crossfade):
    w = _wrapper(geometry)
    bands = _bands(geometry, B, 13)
    p, _, _, _, prod = _stage_inputs(w, bands)
    prev = _tail(w, B, crossfade)
    mode = _mode(crossfade, B)
    want, want_tail = pm.resynth_plain(prod, p.table, p.wsq, p.window, prev,
                                       w._fade_out, w._fade_in, B, p.Tb,
                                       p.n_fft, p.hop, p.win, mode)
    got, tail = _emu_resynth(emulated, prod, p, B, prev, w._fade_out,
                             w._fade_in, mode)
    assert torch.equal(got, want)
    if mode != pm.NO_FADE:
        assert torch.equal(tail, want_tail)
