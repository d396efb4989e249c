"""The precision tiers ``bf16x3`` and ``default`` of the port against
pqmf_tpu on the CPU.

- ``bf16x3``: the port's plain K1-K6 and ``StreamingPQMF`` / ``PQMF`` at the
  tier against the JAX package's Pallas kernels at
  ``mxu_precision="bf16x3"`` in interpret mode, where its split-bf16 scheme
  (``_split_bf16`` / ``_prec_dot``) runs for real.
- ``default``: JAX on the CPU computes this tier in f32 (XLA ignores
  ``Precision.DEFAULT`` there), so the reference is a NumPy model: every
  operand rounded to bf16, to nearest even, and the sums in float64.
- Against JAX at ``highest``: the JAX package's own tier bars —
  ``bf16x3`` within 5e-5 peak-relative (``tests/test_kernels.py``), the
  ``default`` round trip >= 45 dB, the flagship >= 90 dB at ``bf16x3`` and
  > 35 dB at ``default`` (``tests/test_pipelines.py``).
- Artifacts saved by pqmf_tpu at either tier load in the port at that tier.

Tolerance against the reference of the same tier: atol=2e-5 / rtol=1e-4,
the JAX package's kernel-vs-lax bar (the same exact products summed in
another order). On the CPU the port's wrappers run their plain versions;
the tier kernels K1t/K2t/K3t are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import SHIFTS16

from pqmf_tpu import PQMF as JPQMF
from pqmf_tpu.kernels import cached_conv as jcc
from pqmf_tpu.kernels import polyphase as jpk
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.ops import stft as jS
from pqmf_tpu.pipelines import PQMFPitchShiftWrapper as JWrapper
from pqmf_tpu.streaming import StreamingPQMF as JStreamingPQMF
from pqmf_tpu.streaming import centered_padding
from pqmf_tpu.streaming import kernels_from_params as j_kernels
from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,
                            PQMFPitchShiftWrapperTA, PQMFWrapper,
                            StreamingPQMF, load_artifact, stream_ola)
from pqmf_tpu_torch.kernels import _build
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import filterbank as tfb
from pqmf_tpu_torch.ops import stft as tS
from pqmf_tpu_torch.utils.metrics import snr_db

TOL = dict(atol=2e-5, rtol=1e-4)
TIERS = ("bf16x3", "default")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, **{**TOL, **kw})


def _peak_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _bank(M):
    hkf, hki = j_kernels(jfb.build_filterbank(100, M))
    return np.asarray(hkf), np.asarray(hki)


# ---------------------------------------------------------------------------
# the NumPy model of a tier: operands rounded to bf16, float64 sums
# ---------------------------------------------------------------------------


def bf16(a):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32)


def _np_conv(x, w, stride=1, pad=(0, 0)):
    x = np.pad(np.asarray(x, np.float64), ((0, 0), (0, 0), tuple(pad)))
    K = w.shape[-1]
    T_out = (x.shape[-1] - K) // stride + 1
    idx = np.arange(T_out)[:, None] * stride + np.arange(K)[None]
    return np.einsum("bitk,oik->bot", x[:, :, idx], np.asarray(w, np.float64))


def model_conv(x, w, tier, stride=1, pad=(0, 0)):
    """A tier's conv: hi*hi (+ hi*lo + lo*hi at bf16x3) in float64."""
    xh, wh = bf16(x), bf16(w)
    y = _np_conv(xh, wh, stride, pad)
    if tier == "bf16x3":
        xl = bf16(np.float32(x) - xh)
        wl = bf16(np.float32(w) - wh)
        y = y + _np_conv(xh, wl, stride, pad) + _np_conv(xl, wh, stride, pad)
    return y


def _mask(y, offset=0):
    y = np.array(y)
    y[..., 1::2, offset % 2::2] *= -1
    return y


def model_k1(x, w, M, tier, pad=(0, 0), fuse_mask=True):
    y = model_conv(x, w, tier, M, pad)
    return (_mask(y) if fuse_mask else y).astype(np.float32)


def model_k2(x, w, tier, fuse_mask=True, x_offset=0):
    M = w.shape[0]
    y = model_conv(_mask(x, x_offset) if fuse_mask else x, w, tier) * M
    return np.ascontiguousarray(y[:, ::-1].transpose(0, 2, 1)).astype(
        np.float32)


def assert_close_but_mid_flips(got, ref, sub, w_syn):
    """A "default" round trip against its model. The f32 sub-bands of the
    port and of the model differ by an f32 rounding, so where one lies at
    a bf16 rounding boundary their bf16 mids differ by one bf16 ulp (about
    2^-16 of the mids). Every output is within the kernel bar but those
    such a flip reaches (at most Ks*M outputs a flip, a few percent here),
    and those are within one flip: one ulp of the largest sub-band times
    the largest |w_syn| times the gain M."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.astype(np.float64) - ref)
    off = err > TOL["atol"] + TOL["rtol"] * np.abs(ref)
    M = w_syn.shape[0]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(sub).max())) - 7)
    assert off.mean() <= 0.05, off.mean()
    assert err.max() <= TOL["atol"] + ulp * np.abs(w_syn).max() * M, \
        err.max()


def model_k3(x, w_ana, w_syn, M, tier, syn_pad):
    sub = np.pad(model_k1(x, w_ana, M, tier), ((0, 0), (0, 0), syn_pad))
    return model_k2(sub, w_syn, tier, x_offset=-syn_pad[0])


def test_bf16_model_rounds_like_torch():
    a = _rand(0, 4096) * np.float32(1e3)
    a[:4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8), 0.0]
    np.testing.assert_array_equal(
        bf16(a), _t(a).to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# the tier names and the split
# ---------------------------------------------------------------------------


def test_check_precision_takes_the_three_tiers():
    assert tfb.PRECISIONS == ("highest", "bf16x3", "default")
    for tier in tfb.PRECISIONS:
        assert tfb.check_precision(tier) == tier
    for bad in ("high", "fp32", "", None):
        with pytest.raises(ValueError, match="'highest', 'bf16x3', "
                                             "'default'"):
            tfb.check_precision(bad)


def test_split_bf16_is_jax_split():
    a = _rand(1, 3, 1000) * np.float32(7.0)
    hi, lo = tfb.split_bf16(_t(a))
    j_hi, j_lo = jcc._split_bf16(jnp.asarray(a))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(j_hi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(j_lo.astype(jnp.float32)))
    assert hi.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy(), bf16(a))


@pytest.mark.parametrize("tier", TIERS)
def test_conv1d_tier_is_the_model(tier):
    x, w = _rand(2, 2, 3, 200), _rand(3, 4, 3, 17)
    got = tfb._conv1d(_t(x), _t(w), stride=2, padding=(3, 1), precision=tier)
    _close(got, model_conv(x, w, tier, 2, (3, 1)))
    assert not np.array_equal(
        got.numpy(), tfb._conv1d(_t(x), _t(w), 2, (3, 1)).numpy())


# ---------------------------------------------------------------------------
# K1-K3 at the tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("fuse_mask", [True, False])
def test_k1_tier(M, tier, fuse_mask):
    hkf, _ = _bank(M)
    K = hkf.shape[-1]
    x = _rand(M, 2, 1, 39 * M + K - 9)
    got = cc.strided_analysis_conv(_t(x), _t(hkf), M, fuse_mask,
                                   pad=(3, 6), mxu_precision=tier)
    _close(got, model_k1(x, hkf, M, tier, (3, 6), fuse_mask))
    if tier == "bf16x3":
        xx = np.pad(x, ((0, 0), (0, 0), (3, 6)))
        _close(got, jcc.strided_analysis_conv(
            jnp.asarray(xx), jnp.asarray(hkf), M, fuse_mask=fuse_mask,
            mxu_precision="bf16x3"))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("fuse_mask,x_offset", [(True, -16), (True, -15),
                                                (False, 0)])
def test_k2_tier(M, tier, fuse_mask, x_offset):
    _, hki = _bank(M)
    x = _rand(M - x_offset, 2, M, 37 + hki.shape[-1] - 1)
    got = cc.dense_synthesis_conv(_t(x), _t(hki), fuse_mask, x_offset,
                                  mxu_precision=tier)
    _close(got, model_k2(x, hki, tier, fuse_mask, x_offset))
    if tier == "bf16x3":
        _close(got, jcc.dense_synthesis_conv(
            jnp.asarray(x), jnp.asarray(hki), fuse_mask=fuse_mask,
            x_offset=x_offset, mxu_precision="bf16x3"))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M,T", [(8, 8 * 40), (16, 16 * 64)])
def test_k3_tier(M, T, tier):
    hkf, hki = _bank(M)
    al, ar = centered_padding(hkf.shape[-1])
    syn_pad = centered_padding(hki.shape[-1])
    xx = np.pad(_rand(T, 1, 1, T), ((0, 0), (0, 0), (al, ar)))
    got = cc.fused_roundtrip_conv(_t(xx), _t(hkf), _t(hki), M, syn_pad,
                                  mxu_precision=tier)
    want = model_k3(xx, hkf, hki, M, tier, syn_pad)
    if tier == "bf16x3":
        _close(got, want)
    else:
        assert_close_but_mid_flips(got, want, model_k1(xx, hkf, M, tier),
                                   hki)
    if tier == "bf16x3":
        _close(got, jcc.fused_roundtrip_conv(
            jnp.asarray(xx), jnp.asarray(hkf), jnp.asarray(hki), M, syn_pad,
            mxu_precision="bf16x3"))


@pytest.mark.parametrize("tier", TIERS)
def test_k3_tier_is_the_composition_split_again(tier):
    """Plain K3t is plain K1t (f32 sub-bands), the pad, then plain K2t,
    which splits the f32 sub-bands again: bit-equal to that composition."""
    hkf, hki = (_t(a) for a in _bank(8))
    x = _t(_rand(5, 2, 1, 8 * 30 + hkf.shape[-1] - 1))
    for pad in [(16, 16), (3, 0)]:
        sub = torch.nn.functional.pad(
            cc.strided_analysis_conv(x, hkf, 8, mxu_precision=tier), pad)
        comp = cc.dense_synthesis_conv(sub, hki, x_offset=-pad[0],
                                       mxu_precision=tier)
        np.testing.assert_array_equal(
            cc.fused_roundtrip_conv(x, hkf, hki, 8, pad,
                                    mxu_precision=tier).numpy(), comp.numpy())


def test_wrappers_refuse_an_unknown_tier():
    hkf, hki = (_t(a) for a in _bank(8))
    x = _t(np.zeros((1, 1, 600), np.float32))
    for call in (lambda: cc.strided_analysis_conv(x, hkf, 8,
                                                  mxu_precision="hi"),
                 lambda: cc.dense_synthesis_conv(
                     _t(np.zeros((1, 8, 60), np.float32)), hki,
                     mxu_precision="hi"),
                 lambda: cc.fused_roundtrip_conv(x, hkf, hki, 8, (16, 16),
                                                 mxu_precision="hi")):
        with pytest.raises(ValueError, match="unknown precision"):
            call()


# ---------------------------------------------------------------------------
# K4-K6 at the tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [4, 16])
def test_polyphase_tiers(M, tier):
    p = jfb.build_filterbank(100, M)
    hp, hi = p["hk_poly"], p["hk_ipoly"]
    L = hp.shape[-1]
    x, s = _rand(3 * M, 2, 1, M * 37), _rand(3 * M + 1, 2, M, 37)
    ana = pk.polyphase_analysis(_t(x), _t(hp), mxu_precision=tier)
    syn = pk.polyphase_synthesis(_t(s), _t(hi), mxu_precision=tier)
    rt = pk.polyphase_roundtrip(_t(x), _t(hp), _t(hi), mxu_precision=tier)
    # the model: K4/K5/K6's routes over the K1/K2 models (the routes equal
    # the polyphase formula, tests/test_torch_offline.py)
    w2 = pk.analysis_weights(_t(hp)).numpy()
    m_ana = model_k1(x, w2, M, tier, pad=(L // 2 * M, (L - L // 2 - 1) * M))
    off = L // 2 - 1
    m_syn = model_k2(np.pad(s, ((0, 0), (0, 0), (off, L - 1 - off))), hi,
                     tier, x_offset=-off).reshape(2, 1, -1)
    m_rt = model_k2(np.pad(m_ana, ((0, 0), (0, 0), (off, L - 1 - off))), hi,
                    tier, x_offset=-off).reshape(2, 1, -1)
    _close(ana, m_ana)
    _close(syn, m_syn)
    if tier == "bf16x3":
        _close(rt, m_rt)
    else:
        assert_close_but_mid_flips(rt, m_rt, m_ana, hi)
    if tier == "bf16x3":
        j_ana = jpk.polyphase_analysis(jnp.asarray(x), hp,
                                       mxu_precision="bf16x3")
        _close(ana, j_ana)
        _close(syn, jpk.polyphase_synthesis(jnp.asarray(s), hi,
                                            mxu_precision="bf16x3"))
        if jpk.roundtrip_supported(M, L):
            j_rt = jpk.polyphase_roundtrip(jnp.asarray(x), hp, hi,
                                           mxu_precision="bf16x3")
        else:  # the JAX gate differs from the port's: compare outputs
            j_rt = jpk.polyphase_synthesis(j_ana, hi, mxu_precision="bf16x3")
        _close(rt, j_rt)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [2, 16, 64])
def test_polyphase_routes_at_tiers_match_plain(M, tier):
    """The CUDA routes of K4-K6 at a tier (over K1t-K3t's contracts: their
    plain versions here) equal the polyphase formula at the tier."""
    p = jfb.build_filterbank(100, M)
    hp, hi = _t(p["hk_poly"]), _t(p["hk_ipoly"])
    w2 = pk.analysis_weights(hp)
    x, s = _rand(M, 2, 1, M * 9), _rand(M + 1, 2, M, 9)
    _close(pk.analysis_over_k1(_t(x), w2, M, tier),
           pk.polyphase_analysis_plain(_t(x), hp, tier))
    _close(pk.synthesis_over_k2(_t(s), hi, tier),
           pk.polyphase_synthesis_plain(_t(s), hi, tier))
    _close(pk.roundtrip_over_k3(_t(x), w2, hi, M, tier),
           pk.polyphase_roundtrip_plain(_t(x), hp, hi, tier))


# ---------------------------------------------------------------------------
# StreamingPQMF and PQMF at the tiers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def signal():
    return _rand(4, 1, 1, 16 * 256)


@pytest.fixture(scope="module")
def j_streaming():
    return {tier: JStreamingPQMF(100, 16, use_pallas=True, precision=tier)
            for tier in ("highest", "bf16x3")}


def test_streaming_bf16x3_matches_jax(j_streaming, signal):
    jp = j_streaming["bf16x3"]
    tp = StreamingPQMF(100, 16, precision="bf16x3", device="cpu")
    sub = np.asarray(jp.forward(signal))
    _close(tp.forward(signal), sub)
    _close(tp.inverse(sub), jp.inverse(sub))
    _close(tp.roundtrip(signal), jp.roundtrip(signal))
    st, jst = tp.init_state(), jp.init_state()
    for blk in np.split(signal, 4, axis=-1):
        st, y = tp.process_block(st, blk)
        jst, jy = jp.process_block(jst, blk)
        _close(y, jy)


def test_streaming_default_matches_the_model(signal):
    tp = StreamingPQMF(100, 16, precision="default", device="cpu")
    hkf, hki = tp.hkf.numpy(), tp.hki.numpy()
    sub = model_k1(signal, hkf, 16, "default", centered_padding(513))
    _close(tp.forward(signal), sub)
    sl, sr = centered_padding(hki.shape[-1])
    want = model_k2(np.pad(sub, ((0, 0), (0, 0), (sl, sr))), hki, "default",
                    x_offset=-sl).reshape(1, 1, -1)
    _close(tp.inverse(sub), want)
    assert_close_but_mid_flips(tp.roundtrip(signal), want, sub, hki)
    causal = model_k1(signal, hkf, 16, "default", (513 - 16, 0))
    _close(tp.forward_causal(signal), causal)


def test_tiers_against_jax_highest(j_streaming, signal):
    """The JAX package's own tier bars (tests/test_kernels.py): bf16x3
    within 5e-5 peak-relative of highest on the round trip, the analysis
    and the synthesis; the default round trip >= 45 dB."""
    jp = j_streaming["highest"]
    ref_rt = np.asarray(jp.roundtrip(signal))
    ref_a = np.asarray(jp.forward(signal))
    ref_s = np.asarray(jp.inverse(ref_a))
    x3 = StreamingPQMF(100, 16, precision="bf16x3", device="cpu")
    assert _peak_rel(x3.roundtrip(signal), ref_rt) <= 5e-5
    assert _peak_rel(x3.forward(signal), ref_a) <= 5e-5
    assert _peak_rel(x3.inverse(ref_a), ref_s) <= 5e-5
    d = StreamingPQMF(100, 16, precision="default", device="cpu")
    db = snr_db(ref_rt, d.roundtrip(signal).numpy())
    assert 45 <= db < 80, db  # one bf16 pass: ~50 dB, not f32


@pytest.mark.parametrize("tier", TIERS)
def test_pqmf_tiers(tier):
    x = _rand(7, 2, 1, 16 * 64)
    tp = PQMF(100, 16, precision=tier, device="cpu")
    hi = PQMF(100, 16, device="cpu")
    sub = tp.forward(x)
    if tier == "bf16x3":
        jp = JPQMF(100, 16, use_pallas=True, precision="bf16x3")
        _close(sub, jp.forward(x))
        _close(tp.inverse(sub.numpy()), jp.inverse(np.asarray(sub)))
        _close(tp.roundtrip(x), jp.roundtrip(x))
    else:
        assert 45 <= snr_db(hi.roundtrip(x).numpy(),
                            tp.roundtrip(x).numpy()) < 80
    # the classic path runs its plain convs at the tier
    cl = PQMF(100, 16, polyphase=False, precision=tier, device="cpu")
    ref = PQMF(100, 16, polyphase=False, device="cpu").forward(x).numpy()
    err = _peak_rel(cl.forward(x), ref)
    assert 0 < err <= (5e-5 if tier == "bf16x3" else 1e-2), err


# ---------------------------------------------------------------------------
# the DFT at the tiers and the wrappers
# ---------------------------------------------------------------------------


def test_dft_default_rounds_both_operands():
    x = _rand(9, 3, 300)
    win = tS.hann_window(128)
    re, im = tS.stft_ri(_t(x), 128, 32, win, precision="default")
    framed = tS._framed(_t(x), 128, 32, win, True, "constant").numpy()
    C, S_ = (b.numpy() for b in tS.dft_basis(128))
    want = np.einsum("bfn,nk->bkf", bf16(framed).astype(np.float64),
                     bf16(C).astype(np.float64)) / np.sqrt(128)
    _close(re, want.astype(np.float32), atol=1e-6)
    # bf16x3 changes only the conv kernels: the DFT stays full f32
    for a, b in zip(tS.stft_ri(_t(x), 128, 32, win, precision="bf16x3"),
                    tS.stft_ri(_t(x), 128, 32, win)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jre, _ = jS.stft_ri(jnp.asarray(x), 128, 32, jnp.asarray(win.numpy()))
    assert 40 < snr_db(np.asarray(jre), re.numpy()) < 80


@pytest.fixture(scope="module")
def j_flagship():
    return JWrapper(100, 16, 2048, 44100, SHIFTS16)


@pytest.mark.parametrize("tier,bar", [("bf16x3", 90.0), ("default", 35.0)])
def test_flagship_tiers_against_jax_highest(j_flagship, tier, bar):
    x = _rand(21, 1, 2 * 2048) * np.float32(0.3)
    tw = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16,
                               precision=tier, device="cpu")
    js, ts = j_flagship.init_state(), tw.init_state()
    for blk in np.split(x, 2, axis=-1):
        js, jy = j_flagship.pitchshift_fn(js, blk)
        ts, ty = tw.pitchshift_fn(ts, blk)
        assert snr_db(np.asarray(jy), ty.numpy()) > bar
    states, ys = tw.pitchshift_streams(tw.init_streams(3),
                                       _rand(22, 3, 2048) * np.float32(0.3))
    assert ys.shape == (3, 2048) and torch.isfinite(ys).all()
    assert snr_db(np.asarray(j_flagship.forward_fn(x[:, :2048])),
                  tw.forward_fn(x[:, :2048]).numpy()) > bar


def test_flagship_bf16x3_matches_jax_bf16x3():
    """Both packages at bf16x3, JAX's kernels in interpret mode."""
    jw = JWrapper(100, 16, 2048, 44100, SHIFTS16, precision="bf16x3",
                  use_pallas=True)
    tw = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16,
                               precision="bf16x3", device="cpu")
    x = _rand(23, 1, 2048) * np.float32(0.3)
    _, jy = jw.pitchshift_fn(jw.init_state(), x)
    _, ty = tw.pitchshift_fn(tw.init_state(), x)
    assert snr_db(np.asarray(jy), ty.numpy()) >= 90.0


@pytest.mark.parametrize("tier", TIERS)
def test_ta_and_stream_ola_take_the_tiers(tier):
    """The TA wrapper and the block harness run at the wrapper's tier:
    bf16x3 within the card bar (90 dB) of highest, default a real bf16
    pass (below f32 agreement) that still carries the signal."""
    shifts = [0, -3, 5, 12, -7, 2, 1, -1]
    x = _rand(24, 1, 1, 2048) * np.float32(0.3)
    ref = PQMFPitchShiftWrapperTA(100, 8, 2048, 44100, shifts,
                                  device="cpu").pitchshifter(x).numpy()
    got = PQMFPitchShiftWrapperTA(100, 8, 2048, 44100, shifts,
                                  precision=tier,
                                  device="cpu").pitchshifter(x).numpy()
    db = snr_db(ref, got)
    assert db >= 90 if tier == "bf16x3" else 20 < db < 90, db
    w = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16, precision=tier,
                              device="cpu")
    w_hi = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16,
                                 device="cpu")
    y = _rand(25, 1, 6000) * np.float32(0.3)
    (p, r), (p_hi, r_hi) = (stream_ola(v, y, 2048, 1024) for v in (w, w_hi))
    assert snr_db(r_hi.numpy(), r.numpy()) >= (90 if tier == "bf16x3"
                                                else 40)
    assert snr_db(p_hi.numpy(), p.numpy()) >= (90 if tier == "bf16x3"
                                                else 20)


# ---------------------------------------------------------------------------
# artifacts saved by pqmf_tpu at a tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
def test_jax_tier_artifacts_load(tmp_path, tier):
    from pqmf_tpu.export import save_artifact as j_save
    from pqmf_tpu.pipelines import PQMFWrapper as JPQMFWrapper

    x = _rand(30, 1, 1, 2048) * np.float32(0.3)
    jw = JPQMFWrapper(100, 16, 2048, precision=tier)
    j_save(jw, str(tmp_path / "w"))
    tw, man = load_artifact(str(tmp_path / "w"), device="cpu")
    assert man["config"]["precision"] == tier
    assert isinstance(tw, PQMFWrapper) and tw.pqmf.precision == tier
    j_rec = np.asarray(jw.process(x)[0])
    t_rec = tw.process(x)[0].numpy()
    if tier == "bf16x3":
        assert _peak_rel(t_rec, j_rec) <= 5e-5
    else:
        assert snr_db(j_rec, t_rec) >= 45

    jf = JWrapper(100, 16, 2048, 44100, SHIFTS16, precision=tier)
    j_save(jf, str(tmp_path / "f"))
    tf, man = load_artifact(str(tmp_path / "f"), device="cpu")
    assert isinstance(tf, PQMFPitchShiftWrapper)
    assert tf.precision == tf.pqmf.precision == tier
    _, jy = jf.pitchshift_fn(jf.init_state(), x[0])
    _, ty = tf.pitchshift_fn(tf.init_state(), x[0])
    assert snr_db(np.asarray(jy), ty.numpy()) > (90 if tier == "bf16x3"
                                                 else 35)


# ---------------------------------------------------------------------------
# gates, launch plans and the build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 32, 64])
def test_tier_kernels_take_every_geometry_highest_takes(M):
    """K1t/K2t fit wherever K1/K2 fit (a bank too large for a block is
    staged in chunks of the reduction); K3t wherever K3 does."""
    for tier in TIERS:
        for K in [M + 1, 257, 513, 2049, 4097, 8193, 12001]:
            for Mb in {M, max(2, M // 2)}:
                if cc.smem_bytes("analysis", M, Mb, K, 0) <= cc.SMEM_LIMIT:
                    assert cc.smem_bytes("analysis", M, Mb, K, 0, tier) \
                        <= cc.SMEM_LIMIT, (M, Mb, K)
        for Ks in [1, 17, 33, 129, 257, 623, 1500]:
            if cc.smem_bytes("synthesis", M, M, 0, Ks) <= cc.SMEM_LIMIT:
                assert cc.smem_bytes("synthesis", M, M, 0, Ks, tier) \
                    <= cc.SMEM_LIMIT, (M, Ks)
            for Ka in [M * 8 + 1, 513, 2049, 9000]:
                assert cc.fused_roundtrip_supported(M, Ka, Ks, tier) == \
                    cc.fused_roundtrip_supported(M, Ka, Ks), (M, Ka, Ks)
        hkf, hki = (_bank(M) if M > 1 else (np.zeros((1, 1, 3)),) * 2)
        assert cc.supports(M, hkf.shape[-1], hki.shape[-1], tier)


@pytest.mark.parametrize("which,B,M,Ka,Ks,T_out", [
    ("analysis", 1, 16, 513, 0, 512), ("analysis", 16, 16, 513, 0, 512),
    ("analysis", 1, 16, 512, 0, 165375), ("analysis", 1, 64, 2049, 0, 300),
    ("analysis", 3, 2, 65, 0, 77), ("synthesis", 1, 16, 0, 33, 512),
    ("synthesis", 1, 16, 0, 32, 165375), ("synthesis", 2, 64, 0, 33, 300),
    ("synthesis", 1, 4, 0, 33, 37), ("roundtrip", 1, 16, 513, 33, 165377),
    ("roundtrip", 215, 16, 513, 33, 256), ("roundtrip", 1, 2, 65, 33, 300),
    ("roundtrip", 1, 16, 513, 33, 512), ("roundtrip", 16, 16, 513, 33, 512),
    ("roundtrip", 1, 16, 512, 32, 165375), ("roundtrip", 2, 4, 129, 33, 777),
    ("roundtrip", 3, 8, 257, 33, 40000)])
def test_tier_plans_fit_and_cover(which, B, M, Ka, Ks, T_out):
    for tier in TIERS:
        gx, gy, gz, threads, tile, aux, split, smem = cc.launch_plan(
            which, B, M, M, Ka, Ks, T_out, precision=tier)
        gate = cc.smem_bytes(which, M, M, Ka, Ks, tier)
        assert smem <= gate <= cc.SMEM_LIMIT
        assert tile % 16 == 0 and gz == 1
        assert 1 <= gx <= B * -(-T_out // tile)
        if which == "roundtrip":
            # K3t: tiles of 16-64 output steps, one a block, for host
            # blocks; whole files persistent tiles of whole m16 pairs
            assert threads == 256 and aux >= tile + Ks - 1 and gy == 1
            if tile <= 64:
                assert gx == B * -(-T_out // tile)
            else:
                assert tile % 32 == 0 and aux % 32 == 0
        else:
            # 4 warps: WK (aux) slices of the reduction x 4/WK row groups
            # of one m16 tile, or (whole files) 4 row groups of two
            assert threads == 128 and aux in (1, 2, 4)
            assert tile * aux == 64 or (tile, aux) == (128, 1)
            assert gy * split >= M and split in (8, 16)
            if tile < 128:  # one tile a block
                assert gx == B * -(-T_out // tile)
        assert cc.launch_plan(which, B, M, M, Ka, Ks, T_out,
                              precision="highest") != (gx, gy, gz, threads,
                                                       tile, aux, split,
                                                       smem)


def test_build_hash_covers_both_sources(tmp_path, monkeypatch):
    copies = []
    for src in _build.SOURCES:
        dst = tmp_path / src.name
        dst.write_text(src.read_text())
        copies.append(dst)
    monkeypatch.setattr(_build, "SOURCES", tuple(copies))
    first = _build._library_path()
    for dst in copies:
        dst.write_text(dst.read_text() + "\n// edit\n")
        now = _build._library_path()
        assert now != first
        first = now


def test_cpu_tiers_count_no_launches(signal):
    cc.reset_launches()
    pk.reset_launches()
    for tier in TIERS:
        StreamingPQMF(100, 16, precision=tier, device="cpu").roundtrip(signal)
        PQMF(100, 16, precision=tier, device="cpu").roundtrip(signal)
    assert cc.LAUNCHES == {"analysis": 0, "synthesis": 0, "roundtrip": 0}
    assert pk.LAUNCHES == {"analysis": 0, "synthesis": 0, "roundtrip": 0}
