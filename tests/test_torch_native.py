"""The port's native C data layer (``pqmf_tpu_torch/native``) against the
JAX package's (``pqmf_tpu/native``, its own build, as
``tests/test_native.py`` runs it) and against the NumPy paths it stands
beside.

The two C layers compute the same loops, so they agree bit for bit on
every input, out-of-range samples included. The C and NumPy paths agree
bit for bit on samples in [-1, 1]; below -1.0 the C encoder writes -32768
where NumPy's writes -32767, in both packages alike: the tests pin that
one-LSB difference, so neither path changes unseen.
"""

import struct

import numpy as np
import pytest

from pqmf_tpu import native as jnative
from pqmf_tpu.utils import audio as jaudio
from pqmf_tpu_torch import native
from pqmf_tpu_torch.utils import audio

SR = 44100


@pytest.fixture
def nat():
    lib = native.get()
    if lib is None:
        pytest.skip("no C compiler available")
    return lib


@pytest.fixture
def jnat():
    lib = jnative.get()
    if lib is None:
        pytest.skip("no C compiler available for the JAX package's layer")
    return lib


def _samples(n, lo, hi, seed):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def _pcm24(vals) -> bytes:
    return b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals)


def test_builds_into_the_ports_build_dir(nat):
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "pqmf_tpu_torch"
    assert path.name.startswith("libpqmf_wavio_") and path.exists()
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "pqmf_tpu_torch"


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-1.3, 1.3)])
def test_encoder_equals_the_jax_packages_c_layer(nat, jnat, lo, hi):
    x = _samples(20001, lo, hi, 0)
    x[:4] = [-1.00002, -1.0, 1.0, 1.00002]
    got = nat.f32_to_pcm16(x)
    want = np.frombuffer(jnat.f32_to_pcm16(x.tobytes()), "<i2")
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_decoders_equal_the_jax_packages_c_layer(nat, jnat):
    rng = np.random.default_rng(1)
    raw16 = rng.integers(-32768, 32768, 5001).astype("<i2").tobytes()
    got = nat.pcm16_to_f32(raw16)
    want = np.frombuffer(jnat.pcm16_to_f32(raw16), np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # a trailing odd byte is dropped by both
    assert np.array_equal(nat.pcm16_to_f32(raw16 + b"\x01"), want)
    vals = rng.integers(-(1 << 23), 1 << 23, 3001)
    vals[:2] = [-(1 << 23), (1 << 23) - 1]
    raw24 = _pcm24(vals)
    got = nat.pcm24_to_f32(raw24)
    assert np.array_equal(got, np.frombuffer(jnat.pcm24_to_f32(raw24),
                                             np.float32))
    assert np.array_equal(got, vals.astype(np.float32) / float(1 << 23))


@pytest.mark.parametrize("n_out,n_norm,n_block,n_window",
                         [(1000, 1000, 256, 256), (1000, 900, 256, 200),
                          (300, 300, 256, 300)])
def test_ola_equals_the_jax_packages_c_layer_and_numpy(nat, jnat, n_out,
                                                       n_norm, n_block,
                                                       n_window):
    """The accumulation, clipped at both ends (to the shorter accumulator)
    and at the shorter of block and window: bit-equal to the JAX package's
    C and to NumPy's slice form."""
    rng = np.random.default_rng(2)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_window) / n_window)
           ).astype(np.float32)
    ours = [np.zeros(n_out, np.float32), np.zeros(n_norm, np.float32)]
    theirs = [a.copy() for a in ours]
    ref = [a.copy() for a in ours]
    n, lim = min(n_block, n_window), min(n_out, n_norm)
    for off in (0, 128, 256, n_out - 100, -32, n_out + 5):
        blk = rng.standard_normal(n_block).astype(np.float32)
        nat.ola_accumulate(*ours, blk, win, off)
        jnat.ola_accumulate(*theirs, blk.tobytes(), win.tobytes(), off)
        lo, hi = max(off, 0), min(off + n, lim)
        if hi > lo:
            ref[0][lo:hi] += (blk[:n] * win[:n])[lo - off:hi - off]
            ref[1][lo:hi] += (win[:n] * win[:n])[lo - off:hi - off]
    for a, b, c in zip(ours, theirs, ref):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_ola_checks_its_buffers(nat):
    out, norm = np.zeros(64, np.float32), np.zeros(64, np.float32)
    blk = np.ones(16, np.float32)
    for bad in (np.zeros(64, np.float64), np.zeros((2, 64), np.float32)[:, 0],
                np.zeros((2, 32), np.float32)):
        with pytest.raises(ValueError):
            nat.ola_accumulate(bad, norm, blk, blk, 0)
    ro = np.zeros(64, np.float32)
    ro.flags.writeable = False
    with pytest.raises(ValueError):
        nat.ola_accumulate(out, ro, blk, blk, 0)


def test_c_and_numpy_paths_agree_in_range(nat, tmp_path, monkeypatch):
    """Samples in [-1, 1]: the same PCM16 and PCM24 bits decoded, the same
    PCM16 file written, by the C and the NumPy path."""
    x = np.stack([_samples(6000, -1.0, 1.0, 3), _samples(6000, -0.5, 0.5, 4)])
    x[0, :2] = [-1.0, 1.0]
    c_path, np_path = str(tmp_path / "c.wav"), str(tmp_path / "np.wav")
    native.CALLS.clear()
    audio.write_wav(c_path, x, SR)
    c_read, _ = audio.read_wav(c_path)
    assert native.CALLS == {"f32_to_pcm16": 1, "pcm16_to_f32": 1}
    raw24 = _pcm24(np.random.default_rng(5).integers(-(1 << 23), 1 << 23,
                                                     999))
    c24 = audio._decode_pcm(raw24, 24)
    monkeypatch.setattr(audio, "_native", lambda: None)
    audio.write_wav(np_path, x, SR)
    np_read, _ = audio.read_wav(np_path)
    with open(c_path, "rb") as a, open(np_path, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(c_read, np_read)
    assert np.array_equal(c24, audio._decode_pcm(raw24, 24))
    assert native.CALLS == {"f32_to_pcm16": 1, "pcm16_to_f32": 1,
                            "pcm24_to_f32": 1}


def test_below_minus_one_the_encoders_differ_by_one_lsb(nat, jnat):
    """Pinned: the C encoders (both packages') scale by 32767 and clip to
    -32768, so -1.00002 writes -32768; the NumPy encoders (both packages')
    clip to -1 first and write -32767. Within half an LSB below -1
    (-1.00001) both write -32767; above +1 both write 32767."""
    x = np.array([-1.00002, -1.5, -1.00001, 1.00002, 2.0], np.float32)
    c_port = nat.f32_to_pcm16(x)
    c_jax = np.frombuffer(jnat.f32_to_pcm16(x.tobytes()), "<i2")
    np_port = (np.clip(x, -1.0, 1.0) * 32767.0).round().astype("<i2")
    assert c_port.tolist() == c_jax.tolist() == [-32768, -32768, -32767,
                                                 32767, 32767]
    assert np_port.tolist() == [-32767, -32767, -32767, 32767, 32767]


def _encoded(mod, x, path):
    mod.write_wav(path, x, SR)
    with open(path, "rb") as f:
        return np.frombuffer(f.read()[44:], "<i2")


def test_write_wav_paths_match_the_jax_packages(nat, jnat, tmp_path,
                                                monkeypatch):
    """Each port path writes the bits of the JAX package's same path, out
    of range too: C with C, NumPy with NumPy."""
    x = _samples(4000, -1.2, 1.2, 6)[None]
    x[0, 0] = -1.00002
    c_port = _encoded(audio, x, str(tmp_path / "a.wav"))
    c_jax = _encoded(jaudio, x, str(tmp_path / "b.wav"))
    assert np.array_equal(c_port, c_jax) and c_port[0] == -32768
    monkeypatch.setattr(audio, "_native", lambda: None)
    monkeypatch.setattr(jaudio, "_native", lambda: None)
    np_port = _encoded(audio, x, str(tmp_path / "c.wav"))
    np_jax = _encoded(jaudio, x, str(tmp_path / "d.wav"))
    assert np.array_equal(np_port, np_jax) and np_port[0] == -32767
    diff = c_port.astype(np.int32) - np_port
    assert set(np.unique(diff).tolist()) <= {-1, 0}
    assert np.array_equal(diff != 0, c_port == -32768)


def test_get_is_none_without_a_compiler(monkeypatch, tmp_path):
    """As the JAX package's ``native.get()``: no compiler, no library, and
    the audio I/O runs its NumPy path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert native.get() is None and native.get() is None
    assert not (tmp_path / "_build").exists()
    x = _samples(100, -1.0, 1.0, 7)
    audio.write_wav(str(tmp_path / "x.wav"), x, SR)
    y, _ = audio.read_wav(str(tmp_path / "x.wav"))
    assert np.array_equal(
        y[0], (np.clip(x, -1, 1) * 32767.0).round().astype(np.float32)
        / 32768.0)


def test_a_failed_build_gives_none(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    bad = tmp_path / "wavio.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    if native._compiler() is None:
        pytest.skip("no C compiler available")
    assert native.get() is None
    assert list((tmp_path / "_build").glob("*.so")) == []
    assert list((tmp_path / "_build").glob("*.log"))


@pytest.mark.parametrize("stereo", [False, True])
def test_blocks_cli_host_ola_runs_in_c_and_equals_numpy(nat, tmp_path,
                                                        monkeypatch, stereo):
    """The blocks CLI's host loop overlap-adds through the C library (one
    call a channel and a stream a block) and writes the arrays the NumPy
    path writes, bit for bit."""
    from pqmf_tpu_torch.cli.blocks import main

    wav = str(tmp_path / "in.wav")
    x = np.stack([_samples(6000, -0.25, 0.25, 8),
                  _samples(6000, -0.25, 0.25, 9)])
    audio.write_wav(wav, x, SR)
    written = {}

    def capture(path, arr, sr, subtype="PCM_16"):
        written.setdefault(tag, {})[path.rsplit("/", 1)[-1]] = np.array(arr)

    monkeypatch.setattr(audio, "write_wav", capture)
    args = [wav, "--block", "1024", "--buffer", "2048", "--n_band", "8",
            "--shifts", "0,4,-5,-12,3,-7,2,-3", "--device", "cpu",
            *(["--stereo"] if stereo else [])]
    tag = "c"
    native.CALLS.clear()
    assert main([*args, "--out_dir", str(tmp_path / "c")]) == 0
    C, n_frames = (2 if stereo else 1), -(-(6000 - 1024) // 512) + 1
    assert native.CALLS["ola_accumulate"] == 2 * n_frames * C
    assert native.CALLS["pcm16_to_f32"] == 1
    tag = "np"
    monkeypatch.setattr(native, "get", lambda: None)
    monkeypatch.setattr(audio, "_native", lambda: None)
    assert main([*args, "--out_dir", str(tmp_path / "n")]) == 0
    assert sorted(written["c"]) == sorted(written["np"]) == [
        "blocktest_pitchshifter.wav", "blocktest_recontructed.wav",
        "nonblock_pitchshifter.wav"]
    for name, a in written["c"].items():
        assert a.shape == (C, 6000) and np.array_equal(a, written["np"][name])


def test_the_pcm_header_reads_back(nat, tmp_path):
    """A file the C encoder wrote is a plain PCM16 WAV (format 1, 16 bits)
    that the stdlib reader takes."""
    path = str(tmp_path / "h.wav")
    audio.write_wav(path, _samples(10, -1, 1, 10), SR)
    with open(path, "rb") as f:
        head = f.read(44)
    tag, ch, sr, _, _, bits = struct.unpack("<HHIIHH", head[20:36])
    assert (tag, ch, sr, bits) == (1, 1, SR, 16)
