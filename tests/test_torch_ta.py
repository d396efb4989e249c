"""The torchaudio-variant wrapper and its resampler — the port against
pqmf_tpu on the CPU.

Bars: ``sinc_resample`` >= 90 dB against JAX; the banded plans bit-equal
(host-side NumPy, copied); ``pitchshifter`` >= 90 dB against the JAX
wrapper and against the port's own per-band loop (the JAX suite's bar).
The JAX wrapper runs its default CPU path (lax convs, the one-hot banded
resample at B=2); the port's kernel wrappers run their plain versions
because the tensors are on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqmf_tpu.ops import resample as jrs
from pqmf_tpu.pipelines import PQMFPitchShiftWrapperTA as JTA
from pqmf_tpu_torch import PQMFPitchShiftWrapperTA, TorchaudioPitchShift
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import resample as trs
from pqmf_tpu_torch.pipelines import _banded_plan
from pqmf_tpu_torch.utils.metrics import snr_db

BAR_DB = 90.0
TA_SHIFTS16 = [3.2, -48.5, 12.3, 0, 7, -24, 1, 2, 3, 4, 5, 6, -6, -12, 9,
               -30]
CONFIGS = {
    # the reference export configuration (PQMFPsWrapper.py:157 range)
    "16x8192": (16, 8192, TA_SHIFTS16),
    # Tb = 256: the reflect pad of 256 reaches the band's length
    "8x2048": (8, 2048, [0, -3, 5, 12, -7, 2, 1, -1]),
    # the chromatic default shifts
    "8x4096": (8, 4096, None),
}


def _rand(seed, *shape, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _db(ref, got):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return snr_db(np.asarray(ref), got)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(config name, JAX wrapper, port wrapper, input [2, 1, buf]) — one
    JAX compile per configuration for the whole module."""
    M, buf, shifts = CONFIGS[request.param]
    x = _rand(11, 2, 1, buf)
    return (request.param, JTA(100, M, buf, shifts_in_semitones=shifts),
            PQMFPitchShiftWrapperTA(100, M, buf, shifts_in_semitones=shifts,
                                    device="cpu"),
            x)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orig,new", [
    (2756, 2920), (2919, 2756), (2064, 2756), (11025, 8268),
    (44100, 22050), (2756, 8268), (5512, 2756)])
def test_sinc_resample_matches_jax(orig, new):
    """The (orig, new) pairs of tests/test_ta_oracle.py."""
    x = _rand(1, 2, 700, scale=0.5)
    ref = np.asarray(jrs.sinc_resample(jnp.asarray(x), orig, new))
    got = trs.sinc_resample(torch.from_numpy(x), orig, new)
    assert got.shape == ref.shape == (2, math.ceil(700 * new / orig))
    assert _db(ref, got) >= BAR_DB


def test_sinc_resample_equal_rates_is_identity():
    x = torch.from_numpy(_rand(2, 2, 300))
    assert trs.sinc_resample(x, 2756, 2756) is x


@pytest.mark.parametrize("orig,new,n_out", [
    (3277, 2756, 512), (172, 2756, 512), (5512, 2756, 256),
    (2919, 2756, 1000), (2756, 2756, 64), (4129, 2756, 37)])
def test_banded_plan_bit_equal(orig, new, n_out):
    ref = jrs.banded_resample_plan(orig, new, n_out)
    got = trs.banded_resample_plan(orig, new, n_out)
    for r, g in zip(ref[:2], got[:2]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[2] == ref[2]
    kern = trs.sinc_resample_kernel(orig, new)
    jkern = jrs.sinc_resample_kernel(orig, new)
    np.testing.assert_array_equal(kern[0], jkern[0])
    assert kern[1:] == jkern[1:]
    cached = _banded_plan(orig, new, n_out)
    np.testing.assert_array_equal(cached[0], ref[0])
    assert not cached[0].flags.writeable


@pytest.mark.parametrize("T,size", [(300, 377), (300, 211), (5, 5),
                                    (1000, 1)])
def test_interpolate_linear_matches_jax(T, size):
    x = _rand(3, 2, T)
    ref = np.asarray(jrs.interpolate_linear(jnp.asarray(x), size))
    got = trs.interpolate_linear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def test_pitchshifter_matches_jax(pair):
    _, jw, tw, x = pair
    ref = np.asarray(jw.pitchshifter(x))
    got = tw.pitchshifter(x)
    assert got.shape == ref.shape == x.shape
    assert _db(ref, got) >= BAR_DB


def test_fused_matches_own_loop(pair):
    _, _, tw, x = pair
    assert _db(tw.pitchshifter_loop(x), tw.pitchshifter(x)) >= BAR_DB


def test_plan_matches_jax(pair):
    """The per-band plan (rates, frame counts, stretch lengths, banded
    weights and starts, buffer geometry) equals the JAX wrapper's."""
    name, jw, tw, x = pair
    Tb = x.shape[-1] // tw.n_band
    ref, got = jw._ta_plan(Tb), tw._ta_plan(Tb)
    for i in range(6):
        np.testing.assert_array_equal(got[i].numpy(), ref[i], err_msg=name)
    assert got[6:] == ref[6:9]
    assert tw._ta_plan(Tb) is got  # cached per Tb


def test_forward_inverse_match_jax(pair):
    _, jw, tw, x = pair
    sub = tw.forward(x)
    np.testing.assert_allclose(sub.numpy(), np.asarray(jw.forward(x)),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(tw.inverse(sub).numpy(),
                               np.asarray(jw.inverse(sub.numpy())),
                               atol=2e-5, rtol=1e-4)


def test_single_band_passes_through():
    """n_band == 1: the 1-band filterbank is a passthrough, so the wrapper
    is the shifter alone at the full rate."""
    w = PQMFPitchShiftWrapperTA(100, 1, 1024, 44100, [12], device="cpu")
    x = _rand(4, 1, 1, 1024)
    want = TorchaudioPitchShift(44100, 12)(x)
    np.testing.assert_allclose(w.pitchshifter(x).numpy(), want.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(w.forward(x).numpy(), x)


def test_zero_shifts_reconstruct():
    """All-zero shifts: the bands pass through, so pitchshifter is the
    round trip."""
    w = PQMFPitchShiftWrapperTA(100, 8, 1024, 44100, [0] * 8, device="cpu")
    x = _rand(5, 1, 1024)
    np.testing.assert_allclose(w.pitchshifter(x).numpy(),
                               w.inverse(w.forward(x)).numpy(), atol=1e-6)


def test_set_weights_respected():
    """pitchshifter reads the bank at each call: a new bank changes the
    output, and the fused path still matches the per-band loop."""
    # octave shifts keep the resample ratios (and their plans) small
    w = PQMFPitchShiftWrapperTA(100, 8, 1024, 44100,
                                [0, 12, -12, 24, -24, 12, -12, 7],
                                device="cpu")
    x = _rand(6, 1, 1, 1024)
    y1 = w.pitchshifter(x).numpy()
    pq = w.pqmf
    pq.set_weights(pq.params, 2.0 * pq.hkf, pq.hki)
    y2 = w.pitchshifter(x).numpy()
    assert np.abs(y2 - y1).max() > 1e-3
    assert _db(w.pitchshifter_loop(x), y2) >= BAR_DB


def test_registry_attributes():
    jw = JTA(100, 4, 2048, 44100)
    tw = PQMFPitchShiftWrapperTA(100, 4, 2048, 44100, device="cpu")
    assert tw.get_methods() == jw.get_methods() == [
        "forward", "inverse", "pitchshifter"]
    assert tw.get_attributes() == jw.get_attributes()
    assert tw.attribute_dict() == jw.attribute_dict()
    assert tw.pitchshifter_out_ch == 2
    assert tw.shifts == [0, 1, 2, 3]
    assert tw.sub_band_sample_rate == jw.sub_band_sample_rate == 11025
    # Python's round is half to even: 2.5 -> 2, -0.5 -> 0, 3.5 -> 4
    half = PQMFPitchShiftWrapperTA(100, 4, 2048, 44100, [2.5, -0.5, 3.5, 1],
                                   device="cpu")
    assert [s.n_steps for s in half.pitch_shifters] == [2, 0, 4, 1]
    assert tw(np.zeros((1, 2048), np.float32)).shape == (1, 4, 512)


def test_buffer_guards():
    w = PQMFPitchShiftWrapperTA(100, 8, 2048, shifts_in_semitones=[12] * 8,
                                device="cpu")
    with pytest.raises(ValueError, match="multiple of n_band"):
        w.pitchshifter(_rand(7, 1, 1, 2044))
    with pytest.raises(ValueError, match="max_buffer_size"):
        w.pitchshifter(_rand(7, 1, 1, 16384))
    with pytest.raises(ValueError, match="max_buffer_size"):
        w.inverse(np.zeros((1, 8, 2048), np.float32))
    with pytest.raises(ValueError, match="input must be"):
        w.pitchshifter(np.zeros((1, 2, 2048), np.float32))
    with pytest.raises(ValueError, match="max_buffer_size"):
        PQMFPitchShiftWrapperTA(100, 8, 16384, device="cpu")
    with pytest.raises(ValueError, match="8 shifts"):
        PQMFPitchShiftWrapperTA(100, 8, 2048, shifts_in_semitones=[1, 2],
                                device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        PQMFPitchShiftWrapperTA(100, 8, 2048, precision="bf16x2", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PQMFPitchShiftWrapperTA(100, 8, 2048, device="cuda")
    # offline whole-file use lifts the limit explicitly
    big = PQMFPitchShiftWrapperTA(100, 8, 2048, shifts_in_semitones=[12] * 8,
                                  max_buffer_size=None, device="cpu")
    assert big.pitchshifter(_rand(8, 1, 1, 8 * 600)).shape == (1, 1, 4800)


def test_cpu_path_counts_no_launches():
    w = PQMFPitchShiftWrapperTA(100, 8, 2048, shifts_in_semitones=[-12] * 8,
                                device="cpu")
    cc.reset_launches()
    w.pitchshifter(_rand(9, 1, 1, 2048))
    w.inverse(w.forward(_rand(9, 1, 1, 2048)))
    assert sum(cc.LAUNCHES.values()) == 0
