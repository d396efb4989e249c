"""The block-streaming harness, the torchaudio-variant artifact and the
port's CLIs against pqmf_tpu on the CPU.

Bars: ``stream_ola``'s pitch stream >= 90 dB against JAX's ``stream_ola``
and its round-trip stream within 2e-5; artifacts load across the two
packages with the same output; each CLI runs in-process on a seeded wav
written to ``tmp_path`` (no fixture outside the test's own directory),
and where a JAX CLI does the same job the two wavs agree to one PCM16
step.
"""

import json
import os

import numpy as np
import pytest
import torch
from oracles import SHIFTS16

from pqmf_tpu.pipelines import PQMFPitchShiftWrapper as JWrapper
from pqmf_tpu.pipelines import PQMFPitchShiftWrapperTA as JTA
from pqmf_tpu.pipelines import stream_ola as j_stream_ola
from pqmf_tpu_torch import (PQMFPitchShiftWrapper, PQMFPitchShiftWrapperTA,
                            load_artifact, save_artifact, stream_ola)
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.ops import stft as tS
from pqmf_tpu_torch.streaming import kernels_from_params
from pqmf_tpu_torch.utils.audio import read_wav, write_wav
from pqmf_tpu_torch.utils.metrics import snr_db

BAR_DB = 90.0
BUF = 2048
PCM16_STEP = 1.0 / 32768 + 1e-9
OCTAVES8 = "12,-12,0,24,-24,12,-12,7"  # small resample ratios: fast plans


def _audio(n, seed, channels=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    f = rng.uniform(110, 1760, (channels, 1))
    x = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(
        (channels, n))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return (JWrapper(100, 16, BUF, 44100, SHIFTS16),
            PQMFPitchShiftWrapper(100, 16, BUF, 44100, SHIFTS16, device="cpu"))


@pytest.fixture
def wav(tmp_path):
    path = str(tmp_path / "in.wav")
    write_wav(path, _audio(6000, 1, channels=2) * 0.5, 44100)
    return path


# ---------------------------------------------------------------------------
# stream_ola
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 2])
def test_stream_ola_matches_jax(pair, C):
    """16 bands x 2048 blocks, overlap 1024, 4.4 blocks of signal."""
    jw, tw = pair
    x = _audio(9000, 2, channels=C)
    jp, jr = j_stream_ola(jw, x, BUF, 1024)
    tp, tr = stream_ola(tw, x, BUF, 1024)
    assert tp.shape == tr.shape == (C, 9000)
    assert snr_db(np.asarray(jp), tp.numpy()) >= BAR_DB
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5,
                               rtol=0)


def test_stream_ola_matches_host_loop(pair):
    """The harness's arithmetic, written out block by block: float64 Hann
    window cast once, stateful pitch steps, per-block round trips."""
    _, w = pair
    block, T = 512, 2000
    x = _audio(T, 3)
    pitch, recon = stream_ola(w, x, block)
    hop = block // 2
    n_frames = -(-(T - block) // hop) + 1
    total = (n_frames - 1) * hop + block
    xp = np.pad(x, ((0, 0), (0, total - T)))
    win = tS.hann_window(block).numpy()
    out, rec, norm = (np.zeros((1, total), np.float32) for _ in range(3))
    state = w.init_state()
    for f in range(n_frames):
        i = f * hop
        blk = xp[:, i:i + block] * win
        state, y = w.pitchshift_fn(state, blk)
        out[:, i:i + block] += y.numpy() * win
        rec[:, i:i + block] += w.forward_fn(blk).numpy() * win
        norm[:, i:i + block] += win * win
    np.testing.assert_allclose(pitch.numpy(), (out / (norm + 1e-8))[:, :T],
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(recon.numpy(), (rec / (norm + 1e-8))[:, :T],
                               atol=1e-5, rtol=1e-4)


def test_stream_ola_shapes_and_guards(pair):
    _, tw = pair
    x = _audio(700, 4)
    pitch, recon = stream_ola(tw, x[0], 1024)  # [T], shorter than a block
    assert pitch.shape == recon.shape == (1, 700)
    assert np.isfinite(pitch.numpy()).all()
    for bad in (1024, -1):
        with pytest.raises(ValueError, match="overlap"):
            stream_ola(tw, x, 1024, overlap=bad)
    cc.reset_launches()
    stream_ola(tw, x, 512, 256)
    assert sum(cc.LAUNCHES.values()) == 0  # plain versions on the CPU


@pytest.mark.parametrize("C", [1, 2])
def test_stream_ola_program_matches_jax(pair, C):
    """The one-geometry programs themselves: the port's
    ``_stream_ola_program(...)(x)`` against the JAX package's, same
    geometry and seeded input, under test_stream_ola_matches_jax's bars."""
    from pqmf_tpu.pipelines import _stream_ola_program as j_program
    from pqmf_tpu_torch.pipelines import _stream_ola_program

    jw, tw = pair
    T, hop = 7000, 1024
    x = _audio(T, 12, channels=C)
    n_frames = -(-(T - BUF) // hop) + 1
    jp, jr = j_program(jw, BUF, hop, n_frames, C, T)(x)
    tp, tr = _stream_ola_program(tw, BUF, hop, n_frames, C, T)(
        torch.from_numpy(x))
    assert tp.shape == tr.shape == (C, T)
    assert snr_db(np.asarray(jp), tp.numpy()) >= BAR_DB
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5,
                               rtol=0)


def _small_flagship(buf=512, shifts=(1, -1, 3, -3)):
    return PQMFPitchShiftWrapper(70, 4, buf, shifts_in_semitones=list(shifts),
                                 device="cpu")


def test_stream_ola_program_is_cached():
    """The JAX package's cache contract (tests/test_pipelines.py:471-516):
    one program per geometry, reused by a repeat call with equal arrays;
    another overlap adds a program; set_weights evicts the old version's
    programs and the audio follows the new bank."""
    w = _small_flagship()
    x = (np.random.default_rng(5).standard_normal((1, 2000)) * 0.1).astype(
        np.float32)
    p1, r1 = stream_ola(w, x, 512)
    fns = w._stream_ola_fns
    assert list(fns) == [(512, 256, 2000, 1, 0)]
    (run,) = fns.values()
    p2, r2 = stream_ola(w, x, 512)
    assert len(fns) == 1 and fns[(512, 256, 2000, 1, 0)] is run
    torch.testing.assert_close(p2, p1, rtol=0, atol=0)
    torch.testing.assert_close(r2, r1, rtol=0, atol=0)

    stream_ola(w, x, 512, overlap=128)
    assert len(fns) == 2 and fns[(512, 256, 2000, 1, 0)] is run

    pq = w.pqmf
    params = fb.params_from_hk(np.asarray(pq.params["hk"]) * 0.5,
                               h=np.asarray(pq.params["h"]))
    bank = (params, *kernels_from_params(params))
    pq.set_weights(*bank)
    p3, r3 = stream_ola(w, x, 512)
    assert list(fns) == [(512, 256, 2000, 1, 1)]
    assert not np.allclose(p3.numpy(), p1.numpy())
    fresh = _small_flagship()
    fresh.pqmf.set_weights(*bank)
    p4, r4 = stream_ola(fresh, x, 512)
    torch.testing.assert_close(p3, p4, rtol=0, atol=0)
    torch.testing.assert_close(r3, r4, rtol=0, atol=0)


def test_stream_ola_cache_does_not_pin_the_wrapper():
    """tests/test_pipelines.py:545-565: the programs live on the wrapper,
    so a dropped wrapper is collectable garbage."""
    import gc
    import weakref

    w = _small_flagship(256, (1, -1, 2, -2))
    x = (np.random.default_rng(6).standard_normal((1, 1000)) * 0.1).astype(
        np.float32)
    stream_ola(w, x, 256)
    assert len(w._stream_ola_fns) == 1
    ref = weakref.ref(w)
    del w
    gc.collect()
    assert ref() is None


# ---------------------------------------------------------------------------
# the torchaudio-variant artifact
# ---------------------------------------------------------------------------


def test_ta_artifact_cross_load(tmp_path):
    from pqmf_tpu.export import load_artifact as j_load
    from pqmf_tpu.export import save_artifact as j_save

    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    shifts = [12, -12, 0, 24, -24, 12, -12, 0, 12, -12, 0, 24, -24, 12, -12,
              7]
    ours = PQMFPitchShiftWrapperTA(100, 16, 2048, 44100, shifts,
                                   max_buffer_size=None, device="cpu")
    ours.pqmf.set_weights(load_pretrained_bank())
    save_artifact(ours, str(tmp_path / "t"))
    man = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert man["kind"] == "PQMFPitchShiftWrapperTA"
    assert man["config"]["sample_rate"] == 44100
    assert man["config"]["shifts_in_semitones"] == shifts
    assert not (tmp_path / "t" / "state.npz").exists()
    theirs, _ = j_load(str(tmp_path / "t"))
    assert isinstance(theirs, JTA) and theirs.max_buffer_size is None
    x = _audio(2048, 5)[None]
    assert snr_db(np.asarray(theirs.pitchshifter(x)),
                  ours.pitchshifter(x).numpy()) >= BAR_DB

    j_save(theirs, str(tmp_path / "j"))
    back, man2 = load_artifact(str(tmp_path / "j"), device="cpu")
    assert isinstance(back, PQMFPitchShiftWrapperTA)
    assert man2["config"] == man["config"]
    assert back.shifts == shifts and back.sub_band_sample_rate == 2756
    for k in ("h", "hk", "hk_poly", "hk_ipoly"):
        np.testing.assert_array_equal(back.pqmf.params[k].numpy(),
                                      ours.pqmf.params[k].numpy())
    np.testing.assert_array_equal(back.pitchshifter(x).numpy(),
                                  ours.pitchshifter(x).numpy())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_cli_vocoder(tmp_path, wav):
    from pqmf_tpu.cli.vocoder import main as j_main

    from pqmf_tpu_torch.cli.vocoder import main

    out, ref = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    assert main([wav, out, "--n_steps", "4", "--device", "cpu"]) == 0
    j_main([wav, ref, "--n_steps", "4", "--cpu"])
    got, sr = read_wav(out)
    want, _ = read_wav(ref)
    assert sr == 44100 and got.shape == want.shape == (1, 6000)
    np.testing.assert_allclose(got, want, atol=PCM16_STEP)


def test_cli_ps_torchaudio(tmp_path, wav):
    from pqmf_tpu.cli.ps_torchaudio import main as j_main

    from pqmf_tpu_torch.cli.ps_torchaudio import main

    common = [wav, "--n_band", "8", "--buffer", "2048", "--shifts",
              OCTAVES8]
    assert main([*common, "--out_dir", str(tmp_path / "t"),
                 "--device", "cpu"]) == 0
    j_main([*common, "--out_dir", str(tmp_path / "j"), "--cpu"])
    for name in ("reconstruido.wav", "ta_pitchshifted.wav"):
        got, sr = read_wav(str(tmp_path / "t" / name))
        want, _ = read_wav(str(tmp_path / "j" / name))
        assert sr == 44100 and got.shape == want.shape == (1, 6144), name
        np.testing.assert_allclose(got, want, atol=PCM16_STEP, err_msg=name)


def test_cli_ps_torchaudio_default_shifts_and_bank(tmp_path, wav, capsys):
    """Without --shifts the shifts are seeded draws; --finetuned installs
    the committed bank."""
    from pqmf_tpu_torch.cli._common import parse_shifts
    from pqmf_tpu_torch.cli.ps_torchaudio import main

    drawn = parse_shifts(None, 4, 3, -48.53, 12.32)
    assert drawn == parse_shifts(None, 4, 3, -48.53, 12.32)
    assert all(-48.53 <= s < 12.32 for s in drawn)
    assert main([wav, "--n_band", "16", "--buffer", "2048", "--shifts",
                 ",".join(["12", "-12"] * 8), "--finetuned",
                 "--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert "hk16_atten100_finetuned" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--scan"], ["--stereo"],
                                   ["--stereo", "--scan", "--finetuned"]])
def test_cli_blocks(tmp_path, wav, extra):
    """The host loop with its host OLA (the native C library, or NumPy:
    the same bits) and the --scan path write the stream wavs and the
    whole-file pass; --stereo keeps both channels."""
    from pqmf_tpu_torch.cli.blocks import main

    args = [wav, "--block", "1024", "--buffer", str(BUF), "--shifts",
            ",".join(str(s) for s in SHIFTS16), "--out_dir",
            str(tmp_path / "o"), "--device", "cpu", *extra]
    assert main(args) == 0
    C = 2 if "--stereo" in extra else 1
    outs = {}
    for name in ("blocktest_pitchshifter.wav", "blocktest_recontructed.wav",
                 "nonblock_pitchshifter.wav"):
        outs[name], sr = read_wav(str(tmp_path / "o" / name))
        assert sr == 44100 and outs[name].shape == (C, 6000), name
        assert np.abs(outs[name]).max() > 0.01, name
    x, _ = read_wav(wav)
    x = x if C == 2 else x.mean(axis=0, keepdims=True)
    rec = outs["blocktest_recontructed.wav"]
    # the round-trip stream rebuilds the input up to the bank's delay
    assert snr_db(x[:, 2048:-2048], rec[:, 2048 + 16:-2048 + 16]) > 25


@pytest.mark.parametrize("extra", [[], ["--stereo"]])
def test_cli_blocks_host_loop_matches_jax(tmp_path, wav, extra):
    """The host loop (float32 NumPy Hann window, the host OLA) against the
    JAX CLI's own host loop on the same wav and flags: the two streams and
    the whole-file pass agree to one PCM16 step."""
    from pqmf_tpu.cli.blocks import main as j_main

    from pqmf_tpu_torch.cli.blocks import main

    common = [wav, "--block", "1024", "--buffer", str(BUF), "--shifts",
              ",".join(str(s) for s in SHIFTS16), *extra]
    assert main([*common, "--out_dir", str(tmp_path / "t"),
                 "--device", "cpu"]) == 0
    j_main([*common, "--out_dir", str(tmp_path / "j"), "--cpu"])
    C = 2 if "--stereo" in extra else 1
    for name in ("blocktest_pitchshifter.wav", "blocktest_recontructed.wav",
                 "nonblock_pitchshifter.wav"):
        got, sr = read_wav(str(tmp_path / "t" / name))
        want, _ = read_wav(str(tmp_path / "j" / name))
        assert sr == 44100 and got.shape == want.shape == (C, 6000), name
        np.testing.assert_allclose(got, want, atol=PCM16_STEP, err_msg=name)


def test_cli_blocks_host_loop_equals_scan(tmp_path, wav):
    from pqmf_tpu_torch.cli.blocks import main

    common = [wav, "--block", "1024", "--buffer", str(BUF), "--shifts",
              ",".join(str(s) for s in SHIFTS16), "--device", "cpu"]
    assert main([*common, "--out_dir", str(tmp_path / "a")]) == 0
    assert main([*common, "--scan", "--out_dir", str(tmp_path / "b")]) == 0
    for name in ("blocktest_pitchshifter.wav", "blocktest_recontructed.wav"):
        a, _ = read_wav(str(tmp_path / "a" / name))
        b, _ = read_wav(str(tmp_path / "b" / name))
        np.testing.assert_allclose(a, b, atol=PCM16_STEP, err_msg=name)


def test_cli_export_pvoc_and_blocks_artifact(tmp_path, wav):
    """export_pvoc saves, reloads and runs the flagship artifact (which
    pqmf_tpu loads too); blocks --artifact serves it."""
    from pqmf_tpu.export import load_artifact as j_load

    from pqmf_tpu_torch.cli.blocks import main as blocks_main
    from pqmf_tpu_torch.cli.export_pvoc import main

    art = str(tmp_path / "art")
    assert main(["--input", wav, "--out_dir", art, "--buffer", str(BUF),
                 "--seed", "0", "--save_audio", "--audio_dir",
                 str(tmp_path / "a"), "--device", "cpu"]) == 0
    shifted, sr = read_wav(str(tmp_path / "a" / "phasevocoder.wav"))
    assert sr == 44100 and shifted.shape == (1, 6144)
    theirs, man = j_load(art)
    assert man["kind"] == "PQMFPitchShiftWrapper"
    ours, _ = load_artifact(art, device="cpu")
    assert theirs.shifts == ours.shifts
    assert all(-24.75 <= s < 12.43 for s in ours.shifts)
    assert blocks_main([wav, "--block", "1024", "--artifact", art,
                        "--out_dir", str(tmp_path / "b"),
                        "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "b" / "nonblock_pitchshifter.wav")


@pytest.mark.parametrize("module", ["vocoder", "ps_torchaudio", "blocks",
                                    "export_pvoc"])
def test_cli_requires_input_and_refuses_missing_cuda(module, wav):
    import importlib

    main = importlib.import_module(f"pqmf_tpu_torch.cli.{module}").main
    with pytest.raises(SystemExit):
        main([])
    args = {"vocoder": [wav, "out.wav"], "ps_torchaudio": [wav],
            "blocks": [wav], "export_pvoc": ["--input", wav]}[module]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([*args, "--device", "cuda"])
