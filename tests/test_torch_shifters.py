"""The port's standalone shifters and the STFT / stretch pieces under them
against pqmf_tpu on the CPU.

Bars: the STFT pieces to f32 round-off (atol 1e-5); the shifters >= 90 dB
against the JAX package, its own parity bar; ``TorchaudioPitchShift``
> 60 dB against the independent torch oracle (``tests/ta_oracle.py``), the
JAX suite's bar for it.

The running phase of ``stretch_accumulate`` is summed in float64 in the
port and in float32 in JAX, whose rounding at hundreds of radians per
frame puts it 64-93 dB from the exact (float64) result on white spectra.
So the stretch is held against torchaudio's algorithm run in float64 and
against JAX no further than the exact result lies from JAX.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from ta_oracle import torch_phase_vocoder, torch_pitch_shift

from pqmf_tpu import shifters as js
from pqmf_tpu.ops import phase_vocoder as jpv
from pqmf_tpu.ops import stft as jS
from pqmf_tpu_torch import shifters as ts
from pqmf_tpu_torch.ops import phase_vocoder as tpv
from pqmf_tpu_torch.ops import resample as rs
from pqmf_tpu_torch.ops import stft as tS
from pqmf_tpu_torch.utils.metrics import snr_db

BAR_DB = 90.0
SUB_SR = round(44100 / 16)  # 2756: the reference's per-band rate
STFT_TOL = dict(atol=1e-5, rtol=0)


def _rand(seed, *shape, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _db(ref, got):
    """SNR in dB; complex arrays count their real and imaginary parts."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    if np.iscomplexobj(ref) or np.iscomplexobj(got):
        ref = np.stack([ref.real, ref.imag])
        got = np.stack([got.real, got.imag])
    return snr_db(ref, got)


# ---------------------------------------------------------------------------
# STFT pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [300, 256, 100, 1])
def test_center_pad_reflect_matches_jax(T):
    """n_fft 512 pads 256 a side: below, at and past the input's length
    (the 8-band x 2048 bands are 256 long). F.pad's reflect raises from
    pad == T on; JAX keeps reflecting, and the port follows JAX."""
    x = _rand(T, 3, T)
    ref = np.asarray(jS._center_pad(jnp.asarray(x), 512, "reflect"))
    got = tS._center_pad(torch.from_numpy(x), 512, "reflect").numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tS._center_pad(torch.from_numpy(x), 512, "constant").numpy(),
        np.asarray(jS._center_pad(jnp.asarray(x), 512, "constant")))
    if T <= 256:
        with pytest.raises(RuntimeError):
            F.pad(torch.from_numpy(x)[:, None], (256, 256), mode="reflect")
    with pytest.raises(ValueError, match="pad_mode"):
        tS._center_pad(torch.from_numpy(x), 512, "circular")


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("length", [None, 900, 1500, 2400])
def test_istft_ri_length_matches_jax(center, length):
    """Centered with a 400-sample Hann window padded to 512; uncentered
    with a flat window (a Hann window's near-zero window-square sum at the
    uncentered edges would divide round-off up, as torch.istft refuses)."""
    x = _rand(1, 2, 1500)
    if center:
        win, jwin = tS.hann_window(400), jS.hann_window(400)
    else:
        win, jwin = torch.ones(512), jnp.ones(512)
    re, im = tS.stft_ri(torch.from_numpy(x), 512, 128, win, center=center,
                        normalized=True, pad_mode="reflect")
    jre, jim = jS.stft_ri(jnp.asarray(x), 512, 128, jwin, center=center,
                          normalized=True, pad_mode="reflect")
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), **STFT_TOL)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), **STFT_TOL)
    got = tS.istft_ri(re, im, 512, 128, win, center=center,
                      normalized=True, length=length)
    ref = np.asarray(jS.istft_ri(jre, jim, 512, 128, jwin, center=center,
                                 normalized=True, length=length))
    assert got.shape == ref.shape
    # the OLA divides by the window-square sum: where it falls toward 0
    # (the last frame's tail, served when length asks past the signal) it
    # divides round-off up, so compare there only the zero padding
    _, wsq = tS.istft_ri_parts(re, im, 512, 128, win)
    wsq = tS._trim_or_pad(wsq[None], wsq.shape[-1], center, length, 512)
    ok = (wsq > 1e-2).expand(got.shape).numpy()
    np.testing.assert_allclose(got.numpy()[ok], ref[ok], **STFT_TOL)
    np.testing.assert_array_equal(got.numpy()[wsq.expand(got.shape) == 0],
                                  0)


@pytest.mark.parametrize("normalized", [True, False])
def test_complex_stft_istft_match_jax(normalized):
    x = _rand(2, 2, 2000)
    win, jwin = tS.hann_window(512), jS.hann_window(512)
    spec = tS.stft(torch.from_numpy(x), 512, 128, win,
                   normalized=normalized, pad_mode="reflect")
    jspec = np.asarray(jS.stft(jnp.asarray(x), 512, 128, jwin,
                               normalized=normalized, pad_mode="reflect"))
    assert spec.dtype == torch.complex64 and spec.shape == jspec.shape
    np.testing.assert_allclose(spec.numpy(), jspec, **STFT_TOL)
    # the matmul DFT agrees with the FFT to round-off
    re, im = tS.stft_ri(torch.from_numpy(x), 512, 128, win,
                        normalized=normalized, pad_mode="reflect")
    np.testing.assert_allclose(re.numpy(), spec.real.numpy(), **STFT_TOL)
    np.testing.assert_allclose(im.numpy(), spec.imag.numpy(), **STFT_TOL)
    for length in (None, 2000):
        got = tS.istft(spec, 512, 128, win, normalized=normalized,
                       length=length)
        ref = jS.istft(jnp.asarray(jspec), 512, 128, jwin,
                       normalized=normalized, length=length)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **STFT_TOL)
    back = tS.istft(spec, 512, 128, win, normalized=normalized, length=2000)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


# ---------------------------------------------------------------------------
# stretch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_steps", [4, -3, 12])
def test_stretch_reference_matches_jax(n_steps):
    rng = np.random.default_rng(3)
    mag = np.abs(rng.standard_normal((2, 513, 20))).astype(np.float32)
    phase = rng.uniform(-3.14, 3.14, (2, 513, 20)).astype(np.float32)
    rate = 1.0 / 2.0 ** (n_steps / 12.0)
    fo = int(20 / rate)
    jm, jp = jpv.stretch_reference(
        jnp.asarray(mag), jnp.asarray(phase), jnp.float32(rate),
        jpv.phase_advance_reference(513, 256, 1024), fo)
    tm, tp = tpv.stretch_reference(
        torch.from_numpy(mag), torch.from_numpy(phase), rate,
        tpv.phase_advance_reference(513, 256, 1024), fo)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6,
                               rtol=0)
    # phases reach ~800 rad: one f32 ulp there is 6.1e-5
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1.3e-4,
                               rtol=0)


def test_phase_advance_is_f64_then_cast():
    np.testing.assert_array_equal(tpv.phase_advance(257, 128, 512).numpy(),
                                  np.asarray(jpv.phase_advance(257, 128,
                                                               512)))


def _exact_stretch(re, im, rate, omega):
    """torchaudio's phase_vocoder run in float64 (tests/ta_oracle.py)."""
    spec = torch.complex(torch.from_numpy(re).double(),
                         torch.from_numpy(im).double())
    return torch_phase_vocoder(spec, rate,
                               torch.from_numpy(omega).double()[:, None])


@pytest.mark.parametrize("n_steps", [1, -3, 7, 12])
def test_stretch_accumulate_scalar_rate(n_steps):
    re, im = _rand(4, 2, 257, 9, scale=1), _rand(5, 2, 257, 9, scale=1)
    rate = 2.0 ** (-n_steps / 12.0)
    fo = int(math.ceil(9 / rate))
    omega = np.asarray(jpv.phase_advance(257, 128, 512))
    jr, ji = jpv.stretch_accumulate(jnp.asarray(re), jnp.asarray(im),
                                    jnp.float32(rate), jnp.asarray(omega), fo)
    tr, ti = tpv.stretch_accumulate(torch.from_numpy(re),
                                    torch.from_numpy(im), rate,
                                    tpv.phase_advance(257, 128, 512), fo)
    got = tr.numpy() + 1j * ti.numpy()
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    exact = _exact_stretch(re, im, rate, omega).numpy()
    assert got.shape == exact.shape == ref.shape
    assert _db(exact, got) >= 120
    assert _db(ref, got) >= _db(exact, ref) - 0.5


def test_stretch_accumulate_per_band_rates():
    """Band-major [M, B, F, frames] with one rate per band, padded to the
    bands' largest frame count: each band's valid frames equal the scalar
    form's."""
    M, frames = 4, 9
    re, im = _rand(6, M, 2, 257, frames, scale=1), _rand(
        7, M, 2, 257, frames, scale=1)
    rates = [2.0 ** (-n / 12.0) for n in (5, -7, 12, -24)]
    fos = [int(math.ceil(frames / r)) for r in rates]
    omega = tpv.phase_advance(257, 128, 512)
    tr, ti = tpv.stretch_accumulate(
        torch.from_numpy(re), torch.from_numpy(im),
        torch.tensor(rates, dtype=torch.float32), omega, max(fos))
    assert tr.shape == (M, 2, 257, max(fos))
    for m in range(M):
        r1, i1 = tpv.stretch_accumulate(torch.from_numpy(re[m]),
                                        torch.from_numpy(im[m]), rates[m],
                                        omega, fos[m])
        np.testing.assert_allclose(tr[m, ..., :fos[m]].numpy(), r1.numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(ti[m, ..., :fos[m]].numpy(), i1.numpy(),
                                   atol=1e-6, rtol=0)
        jr, ji = jpv.stretch_accumulate(
            jnp.asarray(re[m]), jnp.asarray(im[m]), jnp.float32(rates[m]),
            jpv.phase_advance(257, 128, 512), fos[m])
        ref = np.asarray(jr) + 1j * np.asarray(ji)
        exact = _exact_stretch(re[m], im[m], rates[m],
                               omega.numpy()).numpy()
        got = r1.numpy() + 1j * i1.numpy()
        assert _db(exact, got) >= 120
        assert _db(ref, got) >= _db(exact, ref) - 0.5


# ---------------------------------------------------------------------------
# the shifters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_steps", [4, -3, 0, 12])
def test_phase_vocoder_shift_matches_jax(n_steps):
    x = _rand(8, 2, 4000)
    ref = np.asarray(js.PhaseVocoderPitchShift()(x, n_steps))
    got = ts.PhaseVocoderPitchShift()(x, n_steps)
    assert got.shape == ref.shape
    assert _db(ref, got) >= BAR_DB


def test_phase_vocoder_one_frame_fallback_and_shapes():
    """A 300-sample input pads to n_fft: one frame, the reference's direct
    irfft fallback; [T] and [B,1,T] come back in their own shape."""
    x = _rand(9, 2, 300)
    sh = ts.PhaseVocoderPitchShift(1024, 256, 1024)
    ref = np.asarray(js.PhaseVocoderPitchShift(1024, 256, 1024)(x, -24))
    assert sh.geometry(300, -24)[2] == 1
    assert _db(ref, sh(x, -24)) >= BAR_DB
    assert sh(x[0], 3).shape == (300,)
    assert sh(x[:, None], 3).shape == (2, 1, 300)
    with pytest.raises(ValueError, match="input must be"):
        sh(np.zeros((2, 2, 300), np.float32), 3)


def _exact_pvoc_accumulate(x, n_steps):
    """``PhaseVocoderPitchShift(accumulate_phase=True)`` with the stretch
    run exactly: the port's float32 STFT, torchaudio's rule in float64 with
    the shifter's f32-stepwise omega, then in float64 the inverse
    (``torch.istft``, or the direct irfft of the 1-frame fallback), the
    center fit and the port's linear resample."""
    sh = ts.PhaseVocoderPitchShift(accumulate_phase=True)
    T = x.shape[-1]
    Tp, _, fo, rate = sh.geometry(T, n_steps)
    n_fft, hop = sh.n_fft, sh.hop_length
    win = tS.hann_window(sh.win_length)
    re, im = tS.stft_ri(F.pad(torch.from_numpy(x), (0, Tp - T)), n_fft, hop,
                        win)
    omega = tpv.phase_advance_reference(re.shape[1], hop, n_fft).numpy()
    spec = _exact_stretch(re.numpy(), im.numpy(), rate, omega)[..., :fo]
    if fo == 1:
        y = torch.fft.irfft(spec[..., 0], n=n_fft)[..., :sh.win_length]
    else:
        y = torch.istft(spec, n_fft, hop, sh.win_length,
                        window=win.double(), center=True, normalized=True)
    y = ts._center_fit(y, (fo - 1) * hop + n_fft)
    return rs.interpolate_linear(y, T)


def _check_pvoc_accumulate(T, n_steps):
    """``accumulate_phase=True`` runs the running-phase stretch (float64
    phase, see the module docstring), held as the stretch is: >= 120 dB
    against the exact result (measured 130.1-131.5 dB on the CPU), and no
    further from JAX than the exact result lies (JAX 71.3-126.9 dB from
    it, the float32 running phase)."""
    x = _rand(10, 2, T)
    sh = ts.PhaseVocoderPitchShift(accumulate_phase=True)
    ref = np.asarray(js.PhaseVocoderPitchShift(accumulate_phase=True)(
        x, n_steps))
    got = sh(x, n_steps)
    exact = _exact_pvoc_accumulate(x, n_steps).numpy()
    assert (sh.geometry(T, n_steps)[2] == 1) == (T == 300)
    assert got.shape == ref.shape == exact.shape
    assert _db(exact, got) >= 120
    assert _db(ref, got) >= _db(exact, ref) - 0.5
    if T > 300:  # the option takes another rule
        assert _db(ts.PhaseVocoderPitchShift()(x, n_steps), got) < 60


def test_phase_vocoder_accumulate_option():
    _check_pvoc_accumulate(4000, 4)


@pytest.mark.parametrize("T,n_steps", [(4000, -7), (300, -24)])
def test_phase_vocoder_accumulate_other_shapes(T, n_steps):
    """A downward shift, and 300 samples: the 1-frame fallback."""
    _check_pvoc_accumulate(T, n_steps)


@pytest.mark.parametrize("n_steps", [4, -3, 0, 12, -24])
def test_resample_shift_matches_jax(n_steps):
    x = _rand(11, 2, 3001)
    ref = np.asarray(js.ResamplePitchShift(n_steps)(x))
    got = ts.ResamplePitchShift(n_steps)(x)
    assert got.shape == ref.shape
    assert _db(ref, got) >= BAR_DB


def test_pitch_shifter_adapter_matches_jax():
    x = _rand(12, 1, 5000)
    ref = np.asarray(js.PitchShifter(5)(x))
    assert _db(ref, ts.PitchShifter(5)(x)) >= BAR_DB


@pytest.mark.parametrize("n_steps", [1, -3, 7, 12, -24, 5])
def test_torchaudio_shift_matches_jax_and_oracle(n_steps):
    """At the reference's per-band rate and band length (2756 Hz, 512)."""
    x = _rand(13, 2, 512)
    sh = ts.TorchaudioPitchShift(SUB_SR, n_steps)
    got = sh(x)
    ref = np.asarray(js.TorchaudioPitchShift(SUB_SR, n_steps)(x))
    assert got.shape == ref.shape == (2, 512)
    assert _db(ref, got) >= BAR_DB
    oracle = torch_pitch_shift(torch.from_numpy(x), SUB_SR, n_steps).numpy()
    assert _db(oracle, got) > 60


def test_torchaudio_shift_other_geometry_and_short_bands():
    """8 bands of an 8192 buffer (5512 Hz, 1024 samples) against the
    oracle, and 200-sample bands — shorter than the 256-sample reflect pad,
    which torch.stft refuses — against JAX."""
    sub_sr = round(44100 / 8)
    x = _rand(14, 1, 1024)
    for n_steps in (3, -9):
        got = ts.TorchaudioPitchShift(sub_sr, n_steps)(x)
        oracle = torch_pitch_shift(torch.from_numpy(x), sub_sr,
                                   n_steps).numpy()
        assert _db(oracle, got) > 60
    short = _rand(15, 2, 200)
    ref = np.asarray(js.TorchaudioPitchShift(sub_sr, 5)(short))
    assert _db(ref, ts.TorchaudioPitchShift(sub_sr, 5)(short)) >= BAR_DB


@pytest.mark.parametrize("n_steps", [1, 2, 5, 7, -5, -12])
def test_torchaudio_rate_truncates(n_steps):
    """The stretched rate is int(sr/rate), torchaudio's truncation, not
    round(); and n_steps == 0 is the identity."""
    sh = ts.TorchaudioPitchShift(SUB_SR, n_steps)
    assert sh.geometry(512) == js.TorchaudioPitchShift(
        SUB_SR, n_steps).geometry(512)
    assert sh.geometry(512)[3] == int(SUB_SR / sh.rate)
    if n_steps == 1:
        assert int(SUB_SR / sh.rate) != round(SUB_SR / sh.rate)
    x = torch.from_numpy(_rand(16, 1, 512))
    assert ts.TorchaudioPitchShift(SUB_SR, 0)(x) is x
