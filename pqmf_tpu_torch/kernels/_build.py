"""Build and bind the hand-written CUDA kernels (``csrc/cached_conv.cu``).

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so the build takes seconds. The library lands in
``pqmf_tpu_torch/_build/`` (git-ignored), named by a hash of the source and
the flags, so an edited source never reuses a stale build. Nothing is built
or loaded at import time: :func:`load` runs at the first kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "nvcc_command", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cached_conv.cu"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc.exists():
            return str(nvcc)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use")
    return nvcc


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpqmf_cached_conv_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source was built already; returns
    the library's path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    out = _library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                          text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every C signature; pointers and the stream as c_void_p, or
    ctypes would pass them as 32-bit ints and cut them."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pqmf_analysis_conv.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.pqmf_synthesis_conv.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.pqmf_roundtrip_conv.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        p]
    for fn in (lib.pqmf_analysis_conv, lib.pqmf_synthesis_conv,
               lib.pqmf_roundtrip_conv):
        fn.restype = ctypes.c_int
    lib.pqmf_smem_bytes.argtypes = [i, i, i, i, i]
    lib.pqmf_smem_bytes.restype = ctypes.c_size_t
    lib.pqmf_error_string.argtypes = [i]
    lib.pqmf_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib
