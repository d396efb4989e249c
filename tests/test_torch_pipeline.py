"""The flagship slice — pqmf_tpu_torch.PQMFPitchShiftWrapper and the ops
under it — against pqmf_tpu on the CPU.

Geometry: atten 100, 16 bands, m_buffer_size=2048 (Tb=128, win=n_fft=128,
hop=32, crossfade 32). Bar: >= 90 dB SNR against the JAX wrapper, the JAX
package's own parity bar, for outputs and carried tails alike. The JAX
side runs its default CPU path (the lax convs are the Pallas kernels'
plain reference).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import SHIFTS16

from pqmf_tpu.ops import phase_vocoder as jpv
from pqmf_tpu.ops import resample as jrs
from pqmf_tpu.ops import stft as jS
from pqmf_tpu.pipelines import PQMFPitchShiftWrapper as JWrapper
from pqmf_tpu.pipelines import derive_stft_geometry as j_geometry
from pqmf_tpu_torch import PQMFPitchShiftWrapper
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import phase_vocoder as tpv
from pqmf_tpu_torch.ops import resample as trs
from pqmf_tpu_torch.ops import stft as tS
from pqmf_tpu_torch.pipelines import derive_stft_geometry
from pqmf_tpu_torch.utils.metrics import snr_db

BAR_DB = 90.0
BUF = 2048


def _audio(n, seed, batch=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    f = rng.uniform(110, 1760, (batch, 1))
    x = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(
        (batch, n))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return (JWrapper(100, 16, BUF, 44100, SHIFTS16),
            PQMFPitchShiftWrapper(100, 16, BUF, 44100, SHIFTS16, device="cpu"))


def _db(ref, got):
    return snr_db(np.asarray(ref), np.asarray(got))


def test_stateful_blocks_match_jax(pair):
    jw, tw = pair
    js, ts = jw.init_state(), tw.init_state()
    x = _audio(2 * BUF, 0)
    for blk in np.split(x, 2, axis=-1):
        js, jy = jw.pitchshift_fn(js, blk)
        ts, ty = tw.pitchshift_fn(ts, blk)
        assert ty.shape == (1, BUF)
        assert _db(jy, ty) >= BAR_DB
        assert _db(js["prev_tail"], ts["prev_tail"]) >= BAR_DB


def test_stream_step_matches_jax(pair):
    jw, tw = pair
    x = _audio(BUF, 1, batch=4)
    js, ts = jw.init_streams(4), tw.init_streams(4)
    rng = np.random.default_rng(2)
    tail = (0.1 * rng.standard_normal(ts["prev_tail"].shape)).astype(
        np.float32)
    js = {"prev_tail": jnp.asarray(tail)}
    ts = {"prev_tail": torch.from_numpy(tail.copy())}
    for _ in range(2):
        js, jy = jw.pitchshift_streams(js, x)
        ts, ty = tw.pitchshift_streams(ts, x)
        assert ty.shape == (4, BUF)
        assert ts["prev_tail"].shape == (4, 16, 32)
        assert _db(jy, ty) >= BAR_DB
        assert _db(js["prev_tail"], ts["prev_tail"]) >= BAR_DB


def test_forward_fn_matches_jax(pair):
    jw, tw = pair
    x = _audio(BUF, 3)
    assert _db(jw.forward_fn(x), tw.forward_fn(x)) >= BAR_DB


def test_batched_pitchshift_fn_keeps_tail(pair):
    """B > 1 through pitchshift_fn runs without a crossfade and passes the
    tail through untouched (the reference's batch==1 guard)."""
    jw, tw = pair
    x = _audio(BUF, 4, batch=3)[:, None, :]
    tail = torch.full((16, 32), 0.25)
    ts, ty = tw.pitchshift_fn({"prev_tail": tail}, x)
    assert ts["prev_tail"] is tail
    _, jy = jw.pitchshift_fn({"prev_tail": jnp.asarray(tail.numpy())}, x)
    assert ty.shape == (3, BUF)
    assert _db(jy, ty) >= BAR_DB


def test_stateful_facade(pair):
    _, tw = pair
    x = _audio(BUF, 5)
    tw.reset()
    y1 = tw.pitchshift(x)
    y2 = tw.pitchshift(x)
    st, r1 = tw.pitchshift_fn(tw.init_state(), x)
    _, r2 = tw.pitchshift_fn(st, x)
    torch.testing.assert_close(y1, r1, rtol=0, atol=0)
    torch.testing.assert_close(y2, r2, rtol=0, atol=0)
    torch.testing.assert_close(tw(x), tw.forward_fn(x), rtol=0, atol=0)
    assert tw.get_methods() == ["forward", "pitchshift"]
    assert tw.attribute_dict()["m_buffer_size"] == BUF


def test_accumulate_phase_rule_matches_jax():
    jw = JWrapper(100, 16, BUF, 44100, SHIFTS16, phase_rule="accumulate")
    tw = PQMFPitchShiftWrapper(100, 16, BUF, 44100, SHIFTS16,
                               phase_rule="accumulate", device="cpu")
    x = _audio(BUF, 6)
    _, jy = jw.pitchshift_fn(jw.init_state(), x)
    _, ty = tw.pitchshift_fn(tw.init_state(), x)
    assert _db(jy, ty) >= BAR_DB
    with pytest.raises(ValueError, match="phase_rule"):
        PQMFPitchShiftWrapper(100, 16, BUF, phase_rule="other", device="cpu")


def test_short_block_refused(pair):
    """A block whose sub-band length is under the crossfade overlap raises
    (the reference would silently freeze the tail)."""
    _, tw = pair
    with pytest.raises(ValueError, match="shorter than the crossfade"):
        tw.pitchshift_fn(tw.init_state(), _audio(16 * 16, 7))


def test_input_guards(pair):
    _, tw = pair
    with pytest.raises(ValueError, match="multiple of n_band"):
        tw.pitchshift_fn(tw.init_state(), _audio(BUF + 3, 8))
    with pytest.raises(ValueError, match="max_buffer_size"):
        tw.forward_fn(_audio(32768, 8))
    with pytest.raises(ValueError, match="max_buffer_size"):
        PQMFPitchShiftWrapper(100, 16, 32768, device="cpu")
    with pytest.raises(ValueError, match="16 shifts"):
        PQMFPitchShiftWrapper(100, 16, BUF, shifts_in_semitones=[0, 1],
                              device="cpu")


def test_cpu_slice_counts_no_launches(pair):
    _, tw = pair
    cc.reset_launches()
    tw.pitchshift_fn(tw.init_state(), _audio(BUF, 9))
    assert sum(cc.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the ops under the slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buf", [8192, 2048, 1600, 100])
def test_geometry_matches_jax(buf):
    assert derive_stft_geometry(buf, 16) == j_geometry(buf, 16)


@pytest.mark.parametrize("n_fft,hop,win", [(128, 32, 128), (512, 128, 512),
                                           (128, 25, 100)])
def test_stft_roundtrip_parts_match_jax(n_fft, hop, win):
    x = _audio(700, 10, batch=3)
    jwin = jS.hann_window(win)
    twin = tS.hann_window(win)
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    jre, jim = jS.stft_ri(jnp.asarray(x), n_fft, hop, jwin)
    tre, tim = tS.stft_ri(torch.from_numpy(x), n_fft, hop, twin)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=2e-5,
                               rtol=1e-4)
    mask = (np.arange(tre.shape[-1]) < tre.shape[-1] - 2).astype(np.float32)
    jy, jw = jS.istft_ri_parts(jre, jim, n_fft, hop, jwin,
                               frame_mask=jnp.asarray(mask))
    ty, tw = tS.istft_ri_parts(tre, tim, n_fft, hop, twin,
                               frame_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)


def test_zero_frame_phase_is_plus_zero():
    """The matmul DFT gives +0.0 on an all-zero frame (phase 0), where an
    FFT gives -0.0 (phase pi); the stretch reads that phase."""
    re, im = tS.stft_ri(torch.zeros(1, 256), 128, 32, tS.hann_window(128))
    phase = torch.atan2(im, re)
    assert torch.all(phase == 0)
    assert not torch.any(torch.signbit(re))


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (128, 32), (256, 100)])
def test_omega_bit_equal(n_fft, hop):
    F_ = n_fft // 2 + 1
    np.testing.assert_array_equal(
        tpv.phase_advance_reference(F_, hop, n_fft).numpy(),
        np.asarray(jpv.phase_advance_reference(F_, hop, n_fft)))
    # the f64-then-cast construction is NOT the reference's
    f64 = np.asarray(jpv.phase_advance(F_, hop, n_fft))
    assert not np.array_equal(
        tpv.phase_advance_reference(F_, hop, n_fft).numpy(), f64)


def test_principal_angle_matches_jax():
    x = np.concatenate([
        np.linspace(-40, 40, 4001, dtype=np.float32),
        np.float32([math.pi, -math.pi, 3 * math.pi, 0.0, -0.0])])
    np.testing.assert_allclose(
        tpv.principal_angle(torch.from_numpy(x)).numpy(),
        np.asarray(jpv.principal_angle(jnp.asarray(x))), atol=4e-6, rtol=0)


@pytest.mark.parametrize("src_len", [1, 37, 200, 256])
def test_resample_matches_jax(src_len):
    """Gather lerp vs the JAX one-hot matmul lerp. Per sample they may
    differ by two ulps of the output — the products and the clamp case
    (i0 == i1), where the one-hot form sums the weights first — plus one
    ulp of the source coordinate times the local slope: XLA contracts
    ``(i + 0.5) * ratio - 0.5`` into one FMA, PyTorch rounds twice."""
    x = _audio(256, 11, batch=2)
    ref = np.asarray(jrs.interpolate_linear_dynamic(
        jnp.asarray(x), jnp.int32(src_len), 160))
    got = trs.interpolate_linear_dynamic(
        torch.from_numpy(x), torch.tensor(src_len), 160).numpy()
    f32 = np.float32
    src = (np.arange(160, dtype=f32) + f32(0.5)) * (
        f32(src_len) / f32(160)) - f32(0.5)
    src = np.clip(src, f32(0), f32(src_len - 1))
    i0 = np.floor(src).astype(int)
    i1 = np.minimum(i0 + 1, src_len - 1)
    slope = np.abs(x[:, i1] - x[:, i0])
    bound = np.spacing(src) * slope + 2 * np.spacing(np.abs(ref))
    assert np.all(np.abs(got - ref) <= bound)
