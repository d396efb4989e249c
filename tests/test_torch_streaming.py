"""pqmf_tpu_torch.StreamingPQMF against pqmf_tpu.StreamingPQMF on the CPU.

The JAX side runs its Pallas kernels in interpret mode (use_pallas=True),
the port its kernels' plain versions. Tolerance: atol=2e-5 / rtol=1e-4,
the JAX package's own kernel bar.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.streaming import StreamingPQMF as JStreamingPQMF
from pqmf_tpu.streaming import kernels_from_params as j_kernels
from pqmf_tpu_torch import StreamingPQMF, params_from_jax
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import filterbank as tfb
from pqmf_tpu_torch.utils.metrics import aligned_roundtrip_snr_db

TOL = dict(atol=2e-5, rtol=1e-4)
BANK16 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pqmf_tpu", "data",
    "hk16_atten100_finetuned.npz")


def _close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), err_msg=msg,
                               **TOL)


@pytest.fixture(scope="module")
def pair16():
    return (JStreamingPQMF(100, 16, use_pallas=True),
            StreamingPQMF(100, 16, device="cpu"))


@pytest.fixture(scope="module")
def signal():
    return np.random.default_rng(4).standard_normal(
        (1, 1, 16 * 256)).astype(np.float32)


@pytest.mark.parametrize("fn", ["forward", "inverse", "forward_causal",
                                "inverse_causal", "roundtrip"])
def test_offline_modes_match_jax(pair16, signal, fn):
    jp, tp = pair16
    arg = signal if fn in ("forward", "forward_causal", "roundtrip") \
        else np.asarray(jp.forward(signal))
    _close(getattr(tp, fn)(arg), getattr(jp, fn)(arg), fn)


def test_streaming_blocks_match_jax(pair16, signal):
    """4 blocks with carried state, block outputs and final state."""
    jp, tp = pair16
    js, ts = jp.init_state(), tp.init_state()
    for blk in np.split(signal, 4, axis=-1):
        js, jy = jp.process_block(js, jnp.asarray(blk))
        ts, ty = tp.process_block(ts, blk)
        _close(ty, jy)
    for k in js:
        _close(ts[k], js[k], k)


def test_streaming_equals_causal(pair16, signal):
    """Concatenated block outputs equal the causal offline output."""
    _, tp = pair16
    st = tp.init_state()
    outs = []
    for blk in np.split(signal, 8, axis=-1):
        st, sub = tp.forward_block(st, blk)
        outs.append(sub)
    _close(torch.cat(outs, -1), tp.forward_causal(signal))


def test_latency_bookkeeping_matches_jax(pair16):
    jp, tp = pair16
    for k in ("stream_vs_centered_delay", "centered_delay",
              "latency_samples"):
        assert getattr(tp, k) == getattr(jp, k), k
    assert tp.centered_delay == 16


def test_block_parity_guard(pair16):
    _, tp = pair16
    st = tp.init_state()
    with pytest.raises(ValueError, match="odd sub-band length"):
        tp.forward_block(st, np.zeros((1, 1, 16 * 3), np.float32))
    with pytest.raises(ValueError, match="odd sub-band length"):
        tp.inverse_block(st, np.zeros((1, 16, 5), np.float32))
    with pytest.raises(ValueError, match="multiple of n_band"):
        tp.forward_block(st, np.zeros((1, 1, 40), np.float32))


def test_analysis_pad_is_stride_unaware(pair16):
    _, tp = pair16
    from pqmf_tpu_torch.streaming import centered_padding

    assert centered_padding(tp.hkf.shape[-1]) == (256, 256)


@pytest.mark.parametrize("n_band", [8, 4])
def test_stereo_folding_matches_jax(n_band):
    jp = JStreamingPQMF(100, n_band, use_pallas=True, n_channels=2)
    tp = StreamingPQMF(100, n_band, n_channels=2, device="cpu")
    x = np.random.default_rng(n_band).standard_normal(
        (2, 2, n_band * 64)).astype(np.float32)
    sub = tp.forward(x)
    assert sub.shape == (2, 2 * n_band, 64)
    _close(sub, jp.forward(x))
    _close(tp.inverse(sub.numpy()), jp.inverse(np.asarray(jp.forward(x))))
    _close(tp.roundtrip(x), jp.roundtrip(x))
    with pytest.raises(ValueError, match="channel"):
        tp.forward(x[:, :1])


def test_wrong_device_input_refused(pair16):
    _, tp = pair16
    with pytest.raises(ValueError, match="is on"):
        tp.forward(torch.zeros(1, 1, 512, device="meta"))


def test_finetuned_bank_carried_across():
    """The committed fine-tuned bank, installed in both packages, gives the
    same round trip; the port's version bumps and the SNR stays the
    bank's."""
    with np.load(BANK16) as z:
        hk, h = z["hk"], z["h"] if "h" in z.files else None
    jp = JStreamingPQMF(100, 16, use_pallas=True)
    jparams = jfb.params_from_hk(hk, h=h)
    jp.set_weights(jparams, *j_kernels(jparams))
    tp = StreamingPQMF(100, 16, device="cpu")
    v0 = tp.weights_version
    tp.set_weights(params_from_jax({k: np.asarray(v)
                                    for k, v in jparams.items()}))
    assert tp.weights_version == v0 + 1
    for k in jparams:
        np.testing.assert_array_equal(tp.params[k].numpy(),
                                      np.asarray(jparams[k]), err_msg=k)
    # the same bank through the port's own NumPy params_from_hk
    tp2 = StreamingPQMF(100, 16, device="cpu")
    tp2.set_weights(tfb.params_from_hk(hk, h=h))
    np.testing.assert_array_equal(tp2.hkf.numpy(), tp.hkf.numpy())
    np.testing.assert_array_equal(tp2.hki.numpy(), tp.hki.numpy())

    t = np.arange(16 * 512, dtype=np.float32) / 44100
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.1 * np.random.default_rng(0).standard_normal(t.size))
    x = x[None, None, :].astype(np.float32)
    yj, yt = jp.roundtrip(x), tp.roundtrip(x)
    _close(yt, yj)
    snr_t = aligned_roundtrip_snr_db(x[0, 0], yt.numpy()[0, 0],
                                     tp.centered_delay, edge_trim=513)
    snr_j = aligned_roundtrip_snr_db(x[0, 0], np.asarray(yj)[0, 0],
                                     jp.centered_delay, edge_trim=513)
    assert abs(snr_t - snr_j) < 0.5
    designed = StreamingPQMF(100, 16, device="cpu").roundtrip(x)
    snr_d = aligned_roundtrip_snr_db(x[0, 0], designed.numpy()[0, 0],
                                     16, edge_trim=513)
    assert snr_t > snr_d + 20


def test_cpu_path_counts_no_launches(pair16, signal):
    _, tp = pair16
    cc.reset_launches()
    tp.roundtrip(signal)
    tp.inverse(tp.forward(signal))
    assert sum(cc.LAUNCHES.values()) == 0


@pytest.mark.parametrize("stride,causal", [(16, False), (16, True),
                                           (1, True)])
def test_plain_streaming_convs_match_jax(stride, causal):
    """The plain cached-conv helpers: offline_conv vs JAX, and
    streaming_conv over blocks equal to the causal offline conv."""
    from pqmf_tpu import streaming as jst
    from pqmf_tpu_torch import streaming as tst

    rng = np.random.default_rng(stride)
    C = 1 if stride > 1 else 4
    w = rng.standard_normal((4, C, 33)).astype(np.float32)
    x = rng.standard_normal((2, C, 16 * 24)).astype(np.float32)
    ref = jst.offline_conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           causal=causal)
    got = tst.offline_conv(torch.from_numpy(x), torch.from_numpy(w),
                           stride=stride, causal=causal)
    _close(got, ref)
    if causal:
        st = tst.conv_state_init(2, C, 33, stride)
        outs = []
        for blk in np.split(x, 4, axis=-1):
            st, y = tst.streaming_conv(st, torch.from_numpy(blk),
                                       torch.from_numpy(w), stride)
            outs.append(y)
        _close(torch.cat(outs, -1), got)
        assert st.shape == (2, C, 33 - stride)


def test_scan_blocks_matches_jax(pair16):
    """``scan_blocks`` over pre-framed blocks [n, B, C, T] against the
    reference's (``lax.scan``), as tests/test_streaming.py holds it: the
    stacked block outputs and the final state, and each block against a
    loop of ``process_block``."""
    from pqmf_tpu.streaming import scan_blocks as j_scan_blocks
    from pqmf_tpu_torch.streaming import scan_blocks

    jp, tp = pair16
    n_blocks, B = 6, 2048
    x = np.random.default_rng(5).standard_normal(
        (n_blocks, 1, 1, B)).astype(np.float32)
    js, jys = j_scan_blocks(lambda s, b: jp.process_block(s, b),
                            jp.init_state(), jnp.asarray(x))
    ts, tys = scan_blocks(tp.process_block, tp.init_state(), x)
    assert tys.shape == (n_blocks, 1, 1, B)
    _close(tys, jys)
    for k in ("analysis", "synthesis"):
        _close(ts[k], js[k], k)
    state = tp.init_state()
    for i in range(n_blocks):
        state, y = tp.process_block(state, x[i])
        np.testing.assert_array_equal(y.numpy(), tys[i].numpy())
    _, from_tensor = scan_blocks(tp.process_block, tp.init_state(),
                                 torch.from_numpy(x))
    np.testing.assert_array_equal(from_tensor.numpy(), tys.numpy())
    with pytest.raises(ValueError, match="at least one block"):
        scan_blocks(tp.process_block, tp.init_state(), x[:0])


@pytest.mark.parametrize("dtype", [None, torch.float32, np.float32,
                                   jnp.float32, "float32"])
def test_state_takes_the_reference_dtype(pair16, dtype):
    """``init_state`` and ``conv_state_init`` take the reference's
    ``dtype`` argument (float32 by default there) in its spellings; the
    state is float32, as JAX's."""
    from pqmf_tpu.streaming import conv_state_init as j_conv_state_init
    from pqmf_tpu_torch.streaming import conv_state_init

    jp, tp = pair16
    kw = {} if dtype is None else {"dtype": dtype}
    st, js = tp.init_state(2, **kw), jp.init_state(2)
    for k in ("analysis", "synthesis"):
        assert st[k].dtype == torch.float32
        assert tuple(st[k].shape) == js[k].shape
        assert not st[k].any()
    s = conv_state_init(3, 16, 33, 1, **kw)
    js = j_conv_state_init(3, 16, 33, 1)
    assert s.dtype == torch.float32 and tuple(s.shape) == js.shape


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16, np.float64, "int32"])
def test_state_refuses_other_dtypes(pair16, dtype):
    """The kernels take f32 operands only, so any other state dtype is
    refused with a ValueError (not the TypeError of an unknown argument)."""
    from pqmf_tpu_torch.streaming import conv_state_init

    _, tp = pair16
    with pytest.raises(ValueError, match="float32"):
        tp.init_state(1, dtype=dtype)
    with pytest.raises(ValueError, match="float32"):
        conv_state_init(1, 1, 513, 16, "cpu", dtype)
