"""The port's offline PQMF path against pqmf_tpu on the CPU: the plain
polyphase/classic ops, the K4/K5/K6 adapters, ``PQMF``, ``PQMFWrapper``,
artifacts in both directions, the bank loader, WAV I/O and the
``export_pqmf`` CLI.

The JAX side runs as its own tests run it: lax with ``use_pallas=False``,
or its Pallas kernels in interpret mode. On the CPU the port's wrappers run
their plain versions; the CUDA kernels are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Tolerance: the JAX
package's own kernel-vs-lax bar, atol=2e-5 / rtol=1e-4 (f32 sums of up to
1024 products taken in another order).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqmf_tpu import PQMF as JPQMF
from pqmf_tpu.kernels import polyphase as jpk
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu_torch import PQMF, PQMFWrapper, load_artifact, save_artifact
from pqmf_tpu_torch.convert import params_from_jax
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import filterbank as tfb

TOL = dict(atol=2e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, **{**TOL, **kw})


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# plain ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32])
def test_plain_ops_match_jax(M):
    p = jfb.build_filterbank(100, M)
    x, s = _rand(M, 2, 1, M * 40), _rand(M + 1, 2, M, 40)
    _close(tfb.polyphase_forward(_t(x), _t(p["hk_poly"])),
           jfb.polyphase_forward(jnp.asarray(x), p["hk_poly"]))
    _close(tfb.polyphase_inverse(_t(s), _t(p["hk_ipoly"])),
           jfb.polyphase_inverse(jnp.asarray(s), p["hk_ipoly"]))
    _close(tfb.classic_forward(_t(x), _t(p["hk"])),
           jfb.classic_forward(jnp.asarray(x), p["hk"]))
    _close(tfb.classic_inverse(_t(s), _t(p["hk"])),
           jfb.classic_inverse(jnp.asarray(s), p["hk"]))


@pytest.mark.parametrize("M,Tp", [(3, 40), (4, 1), (16, 7)])
def test_classic_inverse_pad_trap(M, Tp):
    """JAX zero-stuffs with lhs_dilation (M*(T'-1)+1 samples, padded
    (P//2-1, P//2+M-1)); the port stuffs to the full M*T' and pads
    (P//2-1, P//2). Both equal the reference's formula,
    ``conv1d(stuffed, flip(hk), padding=P//2)[..., 1:]``, M*T' samples."""
    hk = jfb.build_filterbank(100, M)["hk"]
    s = _rand(M * Tp, 2, M, Tp)
    P = hk.shape[-1]
    stuffed = np.zeros((2, M, M * Tp), np.float32)
    stuffed[..., ::M] = s * M
    ref = torch.nn.functional.conv1d(
        _t(stuffed), torch.flip(_t(hk), (-1,))[None],
        padding=P // 2)[..., 1:]
    got = tfb.classic_inverse(_t(s), _t(hk))
    assert got.shape == (2, 1, M * Tp)
    _close(got, ref.numpy())
    _close(got, jfb.classic_inverse(jnp.asarray(s), hk))


# ---------------------------------------------------------------------------
# K4 / K5 / K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32])
def test_polyphase_plain_match_pallas(M):
    """The port's K4/K5/K6 on the CPU (their plain versions) against the
    JAX package's Pallas adapters in interpret mode."""
    p = jfb.build_filterbank(100, M)
    hp, hi = _t(p["hk_poly"]), _t(p["hk_ipoly"])
    x, s = _rand(2 * M, 2, 1, M * 37), _rand(2 * M + 1, 2, M, 37)
    _close(pk.polyphase_analysis(_t(x), hp),
           jpk.polyphase_analysis(jnp.asarray(x), p["hk_poly"]))
    _close(pk.polyphase_synthesis(_t(s), hi),
           jpk.polyphase_synthesis(jnp.asarray(s), p["hk_ipoly"]))
    if jpk.roundtrip_supported(M, p["hk_ipoly"].shape[-1]):
        ref = jpk.polyphase_roundtrip(jnp.asarray(x), p["hk_poly"],
                                      p["hk_ipoly"])
    else:  # the JAX gate differs from the port's: compare outputs
        ref = jpk.polyphase_synthesis(
            jpk.polyphase_analysis(jnp.asarray(x), p["hk_poly"]),
            p["hk_ipoly"])
    _close(pk.polyphase_roundtrip(_t(x), hp, hi), ref)


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("T_sub", [1, 37])
def test_kernel_routes_match_plain(M, T_sub):
    """The CUDA route of each adapter — w2 layout, input pads, x_offset,
    the dropped first step of K6 — over K1/K2/K3's contracts (their plain
    versions on the CPU) equals the independent polyphase formula."""
    p = jfb.build_filterbank(100, M)
    hp, hi = _t(p["hk_poly"]), _t(p["hk_ipoly"])
    w2 = pk.analysis_weights(hp)
    assert w2.shape == (M, 1, hp.shape[-1] * M) and w2.is_contiguous()
    x, s = _rand(M + T_sub, 3, 1, M * T_sub), _rand(M * T_sub, 3, M, T_sub)
    ana = pk.polyphase_analysis_plain(_t(x), hp)
    _close(pk.analysis_over_k1(_t(x), w2, M), ana.numpy())
    _close(pk.synthesis_over_k2(_t(s), hi),
           pk.polyphase_synthesis_plain(_t(s), hi).numpy())
    _close(pk.roundtrip_over_k3(_t(x), w2, hi, M),
           pk.polyphase_roundtrip_plain(_t(x), hp, hi).numpy())


def test_k4_hands_k1_the_unpadded_input_and_its_pad(monkeypatch):
    """K4's route gives K1 the signal itself and the centered polyphase pad
    ((L//2)*M, (L - L//2 - 1)*M), which K1 applies in-kernel: the padded
    signal is never written."""
    M = 16
    hp = _t(tfb.build_filterbank(100, M)["hk_poly"])
    L = hp.shape[-1]
    x = _t(_rand(3, 2, 1, M * 40))
    seen = {}
    real = cc.strided_analysis_conv

    def spy(xx, w, m, fuse_mask=True, pad=(0, 0), mxu_precision="highest",
            bank=None):
        seen.update(x=xx, pad=tuple(pad), precision=mxu_precision, bank=bank)
        return real(xx, w, m, fuse_mask, pad, mxu_precision, bank)

    monkeypatch.setattr(cc, "strided_analysis_conv", spy)
    got = pk.analysis_over_k1(x, pk.analysis_weights(hp), M)
    assert seen["x"] is x
    assert seen["pad"] == ((L // 2) * M, (L - L // 2 - 1) * M)
    assert seen["precision"] == "highest" and seen["bank"] is None
    _close(got, pk.polyphase_analysis_plain(x, hp).numpy())


@pytest.mark.parametrize("M", [4, 16, 32, 64])
@pytest.mark.parametrize("T_sub", [37, 300])
def test_k4_tiling_model_matches_plain(M, T_sub):
    """K1's tiling (the NumPy model of tests/test_torch_kernels.py) at K4's
    geometry — even K = L*M, the centered pad, band chunks at M=32/64 —
    equals the polyphase formula within the kernel bar."""
    from test_torch_kernels import k1_model

    hp = _t(tfb.build_filterbank(100, M)["hk_poly"])
    L = hp.shape[-1]
    x = _rand(M + T_sub, 2, 1, M * T_sub)
    got = k1_model(x, pk.analysis_weights(hp).numpy(), M, True,
                   pk._analysis_pad(M, L))
    _close(got, pk.polyphase_analysis_plain(_t(x), hp).numpy())


def test_band_shard_plain_matches_pallas():
    """K4/K5 take an even-sized band shard of the bank, as JAX's do."""
    p = jfb.build_filterbank(100, 8)
    x, s = _rand(11, 1, 1, 8 * 20), _rand(12, 1, 4, 20)
    _close(pk.polyphase_analysis(_t(x), _t(p["hk_poly"][2:6])),
           jpk.polyphase_analysis(jnp.asarray(x), p["hk_poly"][2:6]))
    _close(pk.polyphase_synthesis(_t(s), _t(p["hk_ipoly"][:, 2:6])),
           jpk.polyphase_synthesis(jnp.asarray(s), p["hk_ipoly"][:, 2:6]))


def test_polyphase_wrappers_refuse():
    p = tfb.build_filterbank(100, 4)
    hp = _t(p["hk_poly"])
    with pytest.raises(ValueError, match="divisible"):
        pk.polyphase_analysis(torch.zeros(1, 1, 10), hp)
    with pytest.raises(ValueError, match=r"\[B, 1, T\]"):
        pk.polyphase_roundtrip(torch.zeros(1, 2, 8), hp, _t(p["hk_ipoly"]))
    with pytest.raises(TypeError):
        pk.polyphase_analysis(np.zeros((1, 1, 8), np.float32), hp)
    with pytest.raises(ValueError, match="no kernel"):
        pk.polyphase_analysis(torch.zeros(1, 1, 8, device="meta"),
                              hp.to("meta"))


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
def test_gates(M):
    """K1/K2 take every committed polyphase bank; K6 runs wherever the
    JAX gate runs its fused round trip (M = 8 to 64), and at M = 2 and 4,
    which the JAX gate refuses only for its 128-lane grouping of the
    synthesis left pad."""
    p = tfb.build_filterbank(100, M)
    L = p["hk_poly"].shape[-1]
    assert pk.supports(M, L)
    j_gate = jpk.roundtrip_supported(M, L)
    lane_only = not j_gate and M in (2, 4)
    assert pk.roundtrip_supported(M, L * M, L) == (j_gate or lane_only)
    assert j_gate == (M >= 8)


def test_cpu_paths_count_no_launches():
    cc.reset_launches()
    pk.reset_launches()
    x = _rand(0, 2, 1, 16 * 64)
    for polyphase in (True, False):
        pq = PQMF(100, 16, polyphase=polyphase, device="cpu")
        pq.roundtrip(x)
        pq.inverse(pq.forward(x))
    w = PQMFWrapper(100, 16, 1024, device="cpu")
    w.process(x[:1, :, :1024])
    assert pk.LAUNCHES == {"analysis": 0, "synthesis": 0, "roundtrip": 0}
    assert cc.LAUNCHES == {"analysis": 0, "synthesis": 0, "roundtrip": 0}


# ---------------------------------------------------------------------------
# PQMF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("polyphase", [True, False])
@pytest.mark.parametrize("shape", [(16 * 64,), (1, 16 * 64), (3, 1, 16 * 32)])
def test_pqmf_matches_jax(polyphase, shape):
    x = _rand(len(shape), *shape)
    ref = JPQMF(100, 16, polyphase=polyphase, use_pallas=False)
    got = PQMF(100, 16, polyphase=polyphase, device="cpu")
    sub = got.forward(x)
    _close(sub, ref.forward(x))
    _close(got.inverse(sub.numpy()), ref.inverse(np.asarray(ref.forward(x))))
    _close(got.roundtrip(x), ref.roundtrip(x))
    _close(got(x), sub.numpy())


@pytest.mark.parametrize("M", [4, 32, 64])
def test_pqmf_roundtrip_matches_pallas(M):
    """The round trip against the JAX PQMF on its Pallas kernels
    (interpret mode): K6 at every M; JAX composes at M=4 (its gate's
    128-lane grouping) and runs its fused round trip at M=32 and 64."""
    x = _rand(M, 2, 1, M * 40)
    ref = JPQMF(100, M, use_pallas=True)
    got = PQMF(100, M, device="cpu")
    _close(got.roundtrip(x), ref.roundtrip(x))
    _close(got.forward(x), ref.forward(x))


def test_pqmf_channels():
    x = _rand(3, 2, 2, 8 * 50)
    ref = JPQMF(100, 8, n_channels=2, use_pallas=False)
    got = PQMF(100, 8, n_channels=2, device="cpu")
    sub = got.forward(x)
    assert sub.shape == (2, 16, 50)
    _close(sub, ref.forward(x))
    _close(got.inverse(sub), ref.inverse(np.asarray(ref.forward(x))))
    _close(got.roundtrip(x[0]), ref.roundtrip(x[0]))
    with pytest.raises(ValueError, match="channel"):
        got.forward(x[:, :1])


def test_pqmf_single_band_passes_through():
    x = _rand(4, 2, 1, 40)
    pq = PQMF(100, 1, device="cpu")
    for fn in (pq.forward, pq.inverse, pq.roundtrip):
        np.testing.assert_array_equal(fn(x).numpy(), x)
    np.testing.assert_array_equal(np.asarray(JPQMF(100, 1).forward(x)), x)


def test_pqmf_errors():
    with pytest.raises(ValueError, match="power of 2"):
        PQMF(100, 12, device="cpu")
    PQMF(100, 3, polyphase=False, device="cpu")  # classic takes any band count
    pq = PQMF(100, 8, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pq.forward(np.zeros((1, 1, 100), np.float32))
    with pytest.raises(ValueError, match="divisible"):
        pq.roundtrip(np.zeros((1, 1, 100), np.float32))
    with pytest.raises(ValueError, match="rows"):
        pq.inverse(np.zeros((1, 4, 10), np.float32))
    with pytest.raises(ValueError, match="rank"):
        pq.forward(np.zeros((1, 1, 1, 8), np.float32))
    with pytest.raises(ValueError, match="unknown precision"):
        PQMF(100, 8, precision="bf16x2", device="cpu")
    with pytest.raises(ValueError, match="no polyphase form"):
        pq.set_weights(tfb.params_from_hk(_rand(5, 8, 100)))
    with pytest.raises(ValueError, match="is on"):
        pq.forward(torch.zeros(1, 1, 64, device="meta"))


def test_pqmf_classic_non_power_of_two():
    x = _rand(6, 1, 1, 3 * 60)
    ref = JPQMF(100, 3, polyphase=False, use_pallas=False)
    got = PQMF(100, 3, polyphase=False, device="cpu")
    _close(got.roundtrip(x), ref.roundtrip(x))
    _close(got.forward(x), ref.forward(x))


def test_pqmf_set_weights_finetuned():
    """The committed fine-tuned bank, carried over with params_from_jax,
    gives the JAX PQMF's output; the loader here reads the same file."""
    from pqmf_tpu.parallel.training import load_pretrained_bank as j_load

    from pqmf_tpu_torch.parallel import training as tt

    jp = j_load("hk16_atten100_finetuned")
    tp = tt.load_pretrained_bank("hk16_atten100_finetuned")
    for k in jp:
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k]), err_msg=k)
    from pqmf_tpu.parallel.training import available_pretrained_banks

    assert tt.available_pretrained_banks() == available_pretrained_banks()
    with pytest.raises(FileNotFoundError, match="available"):
        tt.load_pretrained_bank("nope")

    x = _rand(7, 1, 1, 16 * 128)
    ref = JPQMF(100, 16, use_pallas=False)
    ref.set_weights(jp)
    got = PQMF(100, 16, device="cpu")
    got.set_weights(params_from_jax({k: np.asarray(v)
                                     for k, v in jp.items()}))
    assert got.hk is got.params["hk"]
    np.testing.assert_array_equal(got.hk.numpy(), np.asarray(ref.hk))
    _close(got.roundtrip(x), ref.roundtrip(x))
    designed = PQMF(100, 16, device="cpu").roundtrip(x).numpy()
    assert np.abs(got.roundtrip(x).numpy() - designed).max() > 1e-4


def test_pqmf_cuda_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PQMF(100, 16, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PQMFWrapper(100, 16, device="cuda")


# ---------------------------------------------------------------------------
# PQMFWrapper, artifacts, CLI
# ---------------------------------------------------------------------------


def _jwrapper(*a, **kw):
    from pqmf_tpu.pipelines import PQMFWrapper as JW

    return JW(*a, use_pallas=False, **kw)


def test_wrapper_matches_jax():
    x = _rand(8, 2, 1, 1024)
    ref = _jwrapper(100, 16, 1024)
    got = PQMFWrapper(100, 16, 1024, device="cpu")
    assert got.get_methods() == ref.get_methods()
    assert got.attribute_dict() == ref.attribute_dict()
    rr, rs = ref.process(x)
    gr, gs = got.process(x)
    _close(gs, rs)
    _close(gr, rr)
    _close(got.forward(x[0]), ref.forward(x[0]))
    _close(got(x), rs)
    with pytest.raises(ValueError, match="max_buffer_size"):
        got.forward(_rand(9, 1, 1, 16 * 1025))
    with pytest.raises(ValueError, match="multiple"):
        got.forward(np.zeros((1, 1, 100), np.float32))
    with pytest.raises(ValueError, match=r"\[batch, 16"):
        got.inverse(np.zeros((1, 8, 10), np.float32))
    with pytest.raises(ValueError, match="exceeds"):
        PQMFWrapper(100, 16, 4096, max_buffer_size=2048, device="cpu")


def test_artifact_wrapper_cross_load(tmp_path):
    """A port artifact loads in pqmf_tpu and a pqmf_tpu artifact in the
    port, with equal outputs (a fine-tuned bank rides along)."""
    from pqmf_tpu.export import load_artifact as j_load
    from pqmf_tpu.export import save_artifact as j_save

    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    x = _rand(10, 1, 1, 2048)
    ours = PQMFWrapper(100, 16, 2048, max_buffer_size=None, device="cpu")
    ours.pqmf.set_weights(load_pretrained_bank())
    save_artifact(ours, str(tmp_path / "t"))
    theirs, man = j_load(str(tmp_path / "t"))
    assert man["kind"] == "PQMFWrapper" and man["format_version"] == 1
    assert theirs.max_buffer_size is None
    _close(ours.process(x)[0], theirs.process(x)[0])

    j_save(theirs, str(tmp_path / "j"))
    back, man2 = load_artifact(str(tmp_path / "j"), device="cpu")
    assert man2["config"] == man["config"]
    for k in ("h", "hk", "hk_poly", "hk_ipoly"):
        np.testing.assert_array_equal(back.pqmf.params[k].numpy(),
                                      ours.pqmf.params[k].numpy())
    np.testing.assert_array_equal(back.pqmf.hkf.numpy(),
                                  ours.pqmf.hkf.numpy())
    np.testing.assert_array_equal(back.process(x)[0].numpy(),
                                  ours.process(x)[0].numpy())


def test_artifact_flagship_cross_load(tmp_path):
    from pqmf_tpu.export import load_artifact as j_load
    from pqmf_tpu.export import save_artifact as j_save

    from pqmf_tpu_torch import PQMFPitchShiftWrapper

    shifts = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
    ours = PQMFPitchShiftWrapper(100, 16, 2048, 44100, shifts,
                                 phase_rule="accumulate", device="cpu")
    tail = _rand(11, 16, ours.band_overlap)
    ours._state = {"prev_tail": _t(tail)}
    save_artifact(ours, str(tmp_path / "t"))
    theirs, man = j_load(str(tmp_path / "t"))
    assert theirs.shifts == shifts and theirs.phase_rule == "accumulate"
    np.testing.assert_array_equal(np.asarray(theirs._state["prev_tail"]),
                                  tail)
    with np.load(tmp_path / "t" / "weights.npz") as z:
        for k in ("fade_out", "fade_in", "rates"):
            np.testing.assert_array_equal(z[k], np.asarray(
                getattr(theirs, "_" + k)), err_msg=k)

    j_save(theirs, str(tmp_path / "j"))
    back, _ = load_artifact(str(tmp_path / "j"), device="cpu")
    assert back.shifts == shifts and back.phase_rule == "accumulate"
    np.testing.assert_array_equal(back._state["prev_tail"].numpy(), tail)
    x = _rand(12, 1, 2048) * 0.3
    _, y_back = back.pitchshift_fn(back._state, x)
    _, y_ours = ours.pitchshift_fn(ours._state, x)
    np.testing.assert_array_equal(y_back.numpy(), y_ours.numpy())


def test_artifact_refusals(tmp_path):
    w = PQMFWrapper(100, 4, 512, device="cpu")
    # an AOT export that fails (a block length the wrapper refuses) raises
    # and writes nothing
    with pytest.raises(RuntimeError, match="torch.export program"):
        save_artifact(w, str(tmp_path / "a"), with_stablehlo=True,
                      example_length=513)
    assert not (tmp_path / "a").exists()
    with pytest.raises(ValueError, match="no artifact"):
        save_artifact(PQMF(100, 4, device="cpu"), str(tmp_path / "b"))
    save_artifact(w, str(tmp_path / "c"))
    man_path = tmp_path / "c" / "manifest.json"
    man = json.loads(man_path.read_text())
    man["kind"] = "PQMFPitchShiftWrapperXL"
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="unknown artifact kind"):
        load_artifact(str(tmp_path / "c"), device="cpu")
    man["kind"] = "PQMFWrapper"
    man["config"]["future_knob"] = 1
    man_path.write_text(json.dumps(man))
    with pytest.warns(UserWarning, match="future_knob"):
        load_artifact(str(tmp_path / "c"), device="cpu")


@pytest.mark.parametrize("subtype,bits", [("PCM_16", 16), ("FLOAT", 32)])
def test_wav_io_matches_jax(tmp_path, subtype, bits):
    from pqmf_tpu.utils import audio as ja

    from pqmf_tpu_torch.utils import audio as ta

    x = np.clip(_rand(13, 2, 999) * 0.4, -1, 1)
    ta.write_wav(str(tmp_path / "t.wav"), x, 22050, subtype=subtype)
    ja.write_wav(str(tmp_path / "j.wav"), x, 22050, subtype=subtype)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    got, sr = ta.read_wav(str(tmp_path / "j.wav"))
    ref, _ = ja.read_wav(str(tmp_path / "j.wav"))
    assert sr == 22050 and got.shape == (2, 999) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, x, atol=2.0 / 2 ** (bits - 1))
    assert ta.rms(x) == ja.rms(x)


@pytest.mark.parametrize("finetuned", [False, True])
def test_cli_export_pqmf(tmp_path, finetuned):
    """The port's CLI and the JAX one on the same wav write the same
    reconstruction (to one PCM16 step)."""
    from pqmf_tpu.cli.export_pqmf import main as j_main

    from pqmf_tpu_torch.cli.export_pqmf import main
    from pqmf_tpu_torch.utils.audio import read_wav, write_wav

    wav = str(tmp_path / "in.wav")
    write_wav(wav, np.clip(_rand(14, 1, 10000) * 0.3, -1, 1), 44100)
    extra = ["--finetuned"] if finetuned else []
    common = ["--input", wav, "--buffer", "4096", *extra]
    assert main([*common, "--out_dir", str(tmp_path / "art"),
                 "--audio_dir", str(tmp_path / "t"),
                 "--device", "cpu"]) == 0
    j_main([*common, "--out_dir", str(tmp_path / "jart"),
            "--audio_dir", str(tmp_path / "j"), "--cpu"])
    got, sr = read_wav(str(tmp_path / "t" / "reconstruido.wav"))
    ref, _ = read_wav(str(tmp_path / "j" / "reconstruido.wav"))
    assert sr == 44100 and got.shape == (1, 12288)
    np.testing.assert_allclose(got, ref, atol=1.0 / 32768 + 1e-9)
    man = json.loads((tmp_path / "art" / "manifest.json").read_text())
    assert man["config"]["m_buffer_size"] == 4096
    assert os.path.exists(tmp_path / "art" / "weights.npz")


def test_k5_plain_rounding_at_m64_is_inside_the_kernel_bar():
    """Why K2 splits its band sum only for banks of <= 16 bands: at M=64 a
    K5 output sums 2,048 products at gain 64, and the f32 plain version is
    itself up to ~2e-5 from the float64 sum — inside K12_TOL (2e-5 /
    1e-4), so a kernel that keeps the plain version's sequential order
    passes, while a second f32 order can add as much again."""
    M, B, T = 64, 4, 512
    hi = torch.tensor(tfb.build_filterbank(100, M)["hk_ipoly"])
    s = torch.from_numpy(_rand(M * 1000 + 16, B, M, T))
    f32 = pk.polyphase_synthesis_plain(s, hi).numpy()
    f64 = pk.polyphase_synthesis_plain(s.double(), hi.double()).numpy()
    err = np.abs(f32 - f64)
    assert np.all(err <= 2e-5 + 1e-4 * np.abs(f64))
    assert 1e-6 < err.max() < 3e-5
