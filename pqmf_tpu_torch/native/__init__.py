"""The port's native (C) host-side data layer — see ``wavio.c``.

Counterpart of ``pqmf_tpu/native/`` (the JAX package's analog of the
reference's torchaudio C++ I/O backends, VocoderPitchShifter.py:309-344):
PCM16/PCM24 decoding, PCM16 encoding and the block harness's windowed
overlap-add, as C loops with the JAX package's arithmetic, bit for bit.
The port keeps its own copy of the source: a plain C interface over
pointers and lengths, built with the C compiler (``$CC``, else ``cc``)
into the git-ignored ``pqmf_tpu_torch/_build/`` at first use, named by a
hash of the source and the flags, and loaded with ``ctypes``. Nothing is
built or loaded at import time.

:func:`get` returns the library's wrappers (:class:`Wavio`), or ``None``
when no C compiler is available or the build fails; the callers
(``utils/audio.py``, ``cli/blocks.py``) then take their NumPy path.
:data:`CALLS` counts each wrapper's calls, so a run can show it went
through the library.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "BUILD_DIR", "CALLS", "Wavio", "build", "get"]

SOURCE = Path(__file__).resolve().parent / "wavio.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

CALLS = collections.Counter()  # calls of each Wavio function

_lib = None
_tried = False


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CC", "cc"))


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"libpqmf_wavio_{digest.hexdigest()[:16]}.so"


def build(quiet: bool = True) -> Path | None:
    """Compile ``wavio.c`` unless this source was built already; returns
    the library's path, or ``None`` without a compiler or when the build
    fails (the compiler's report is kept beside it as ``.log``, and with
    ``quiet=False`` also written to stderr)."""
    out = _library_path()
    if out.exists():
        return out
    cc = _compiler()
    if cc is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cc, *CC_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        report = f"{cc}: {e}\n"
        out.with_suffix(".log").write_text(report)
        if not quiet:
            sys.stderr.write(report)
        return None
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if not quiet:
        sys.stderr.write(proc.stdout + proc.stderr)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def _f32(a: np.ndarray, what: str, writable: bool = False) -> np.ndarray:
    """``a`` as the float32 C-contiguous array the C loops read (a
    writable accumulator must already be one: it is updated in place)."""
    if writable:
        if (not isinstance(a, np.ndarray) or a.dtype != np.float32
                or not a.flags.c_contiguous or not a.flags.writeable):
            raise ValueError(f"{what} must be a writable C-contiguous float32 "
                             f"array")
        return a
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class Wavio:
    """The library's functions over NumPy arrays and bytes. Every size,
    dtype and contiguity is checked here before a pointer reaches C."""

    def __init__(self, lib: ctypes.CDLL):
        p, n = ctypes.c_void_p, ctypes.c_int64
        lib.pqmf_pcm16_to_f32.argtypes = [p, p, n]
        lib.pqmf_f32_to_pcm16.argtypes = [p, p, n]
        lib.pqmf_pcm24_to_f32.argtypes = [p, p, n]
        lib.pqmf_ola_accumulate.argtypes = [p, n, p, n, p, n, p, n, n]
        for fn in (lib.pqmf_pcm16_to_f32, lib.pqmf_f32_to_pcm16,
                   lib.pqmf_pcm24_to_f32, lib.pqmf_ola_accumulate):
            fn.restype = None
        self._lib = lib

    def pcm16_to_f32(self, raw: bytes) -> np.ndarray:
        """Little-endian PCM16 bytes -> float32 in [-1, 1) (a trailing odd
        byte is dropped, as the JAX package's C decoder drops it)."""
        src = np.frombuffer(raw, dtype=np.uint8)
        n = src.size // 2
        out = np.empty(n, np.float32)
        CALLS["pcm16_to_f32"] += 1
        self._lib.pqmf_pcm16_to_f32(_ptr(src), _ptr(out), n)
        return out

    def pcm24_to_f32(self, raw: bytes) -> np.ndarray:
        """Packed little-endian PCM24 bytes -> float32."""
        src = np.frombuffer(raw, dtype=np.uint8)
        n = src.size // 3
        out = np.empty(n, np.float32)
        CALLS["pcm24_to_f32"] += 1
        self._lib.pqmf_pcm24_to_f32(_ptr(src), _ptr(out), n)
        return out

    def f32_to_pcm16(self, x) -> np.ndarray:
        """float32 samples (any shape, read in C order) -> int16, scaled by
        32767, clipped and rounded (see ``wavio.c`` for the one-LSB
        difference from the NumPy encoder below -1.0)."""
        src = _f32(x, "x").reshape(-1)
        out = np.empty(src.size, "<i2")
        CALLS["f32_to_pcm16"] += 1
        self._lib.pqmf_f32_to_pcm16(_ptr(src), _ptr(out), src.size)
        return out

    def ola_accumulate(self, out: np.ndarray, norm: np.ndarray, block,
                       window, offset: int) -> None:
        """``out[offset + i] += block[i] * window[i]`` and ``norm[offset +
        i] += window[i] ** 2`` in place, for ``i`` below the shorter of
        ``block`` and ``window``, clipped to the accumulators' bounds.
        ``out`` and ``norm`` are 1-D writable float32 arrays."""
        out = _f32(out, "out", writable=True)
        norm = _f32(norm, "norm", writable=True)
        if out.ndim != 1 or norm.ndim != 1:
            raise ValueError("out and norm must be 1-D")
        block = _f32(block, "block").reshape(-1)
        window = _f32(window, "window").reshape(-1)
        CALLS["ola_accumulate"] += 1
        self._lib.pqmf_ola_accumulate(_ptr(out), out.size, _ptr(norm),
                                      norm.size, _ptr(block), block.size,
                                      _ptr(window), window.size, int(offset))


def get() -> Wavio | None:
    """The native library's wrappers, built on first use; ``None`` when no
    C compiler is available or the build failed (the NumPy paths run)."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        path = build()
        if path is not None:
            _lib = Wavio(ctypes.CDLL(str(path)))
    return _lib
