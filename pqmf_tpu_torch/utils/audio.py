"""Host-side WAV I/O with no external dependencies.

Counterpart of ``pqmf_tpu/utils/audio.py`` (which replaces the reference's
torchaudio/soundfile loaders, VocoderPitchShifter.py:309-344,
PQMFWrapper.py:113/134) on the stdlib ``wave`` module: PCM 8/16/24/32 and
IEEE float32 WAVs. As in the JAX package, PCM16/24 decoding and PCM16
encoding run in the port's native C library (``pqmf_tpu_torch.native``)
when it builds, and in NumPy when no C compiler is available. The two
paths give the same bits on samples in [-1, 1]; below -1.0 the C encoder
writes -32768 where NumPy's writes -32767 (the JAX package's two paths
differ the same way).
"""

from __future__ import annotations

import struct
import wave

import numpy as np

__all__ = ["read_wav", "write_wav", "rms"]


def _read_float_wav(path: str):
    """Minimal RIFF parser for IEEE-float WAVs (format tag 3), which the
    stdlib ``wave`` module rejects."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    frames = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            frames = body
        pos += 8 + size + (size % 2)
    if fmt is None or frames is None:
        raise ValueError("missing fmt/data chunk")
    tag, n_ch, sr, _, _, bits = fmt
    if tag == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format is the first 2 bytes of
        # the SubFormat GUID (after cbSize, wValidBitsPerSample and
        # dwChannelMask) — extensible PCM32 must not decode as IEEE float
        if len(fmt_body) < 26:
            raise ValueError("extensible WAV without SubFormat GUID")
        (tag,) = struct.unpack("<H", fmt_body[24:26])
    if tag == 3 and bits == 32:
        return np.frombuffer(frames, dtype="<f4").astype(np.float32), n_ch, sr
    if tag == 1:
        return _decode_pcm(frames, bits), n_ch, sr
    raise ValueError(f"unsupported WAV format tag {tag} bits {bits}")


def _native():
    from pqmf_tpu_torch import native

    return native.get()


def _decode_pcm(raw: bytes, bits: int) -> np.ndarray:
    nat = _native()
    if nat is not None:
        if bits == 16:
            return nat.pcm16_to_f32(raw)
        if bits == 24:
            return nat.pcm24_to_f32(raw)
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                / 2147483648.0)
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x)
        return x.astype(np.float32) / float(1 << 23)
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    raise ValueError(f"unsupported PCM bit depth {bits}")


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array [C, T], sample_rate)."""
    try:
        with wave.open(str(path), "rb") as w:
            n_ch = w.getnchannels()
            sr = w.getframerate()
            bits = w.getsampwidth() * 8
            raw = w.readframes(w.getnframes())
        x = _decode_pcm(raw, bits)
    except wave.Error:
        x, n_ch, sr = _read_float_wav(str(path))
    return x.reshape(-1, n_ch).T.copy(), sr


def write_wav(path: str, x: np.ndarray, sr: int, subtype: str = "PCM_16"):
    """Write float32 audio [C, T] or [T] to a WAV file.

    subtype: 'PCM_16' (default, the reference's save path; scaled by 32767,
    clipped and rounded to nearest even) or 'FLOAT' for IEEE float32."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None]
    C, _ = x.shape
    inter = x.T.reshape(-1)
    if subtype == "FLOAT":
        payload = inter.astype("<f4").tobytes()
        with open(path, "wb") as f:
            f.write(b"RIFF")
            f.write(struct.pack("<I", 36 + len(payload)))
            f.write(b"WAVE")
            f.write(b"fmt ")
            f.write(struct.pack("<IHHIIHH", 16, 3, C, sr, sr * C * 4, C * 4,
                                32))
            f.write(b"data")
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)
        return
    if subtype != "PCM_16":
        raise ValueError(f"unknown subtype {subtype!r}: 'PCM_16' or 'FLOAT'")
    nat = _native()
    if nat is not None:
        pcm = nat.f32_to_pcm16(inter)
    else:
        pcm = (np.clip(inter, -1.0, 1.0) * 32767.0).round().astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(C)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def rms(x) -> float:
    """RMS energy, the reference harness's quality metric
    (2-TestBlocks.py:156-163)."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.sqrt(np.mean(x**2)))
