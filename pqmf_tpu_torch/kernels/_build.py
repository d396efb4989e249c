"""Build and bind the hand-written CUDA kernels (``csrc/cached_conv.cu``,
the f32 kernels, ``csrc/cached_conv_tc.cu``, the tensor-core tiers, and
``csrc/middle.cu``, the flagship pitch shifter's middle) and the host side
of a graph replay (``csrc/graph_io.cu``, ``graphs.py``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object, all at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so the build takes seconds. The library lands in
``pqmf_tpu_torch/_build/`` (git-ignored), named by a hash of the sources and
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

__all__ = ["SOURCES", "HEADERS", "BUILD_DIR", "nvcc_command", "link_command",
           "build", "load", "bind_graph_io"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "cached_conv.cu", _PKG / "csrc" / "cached_conv_tc.cu",
           _PKG / "csrc" / "middle.cu", _PKG / "csrc" / "graph_io.cu")
# included by both sources (the fused round trip's call-size tile choice)
HEADERS = (_PKG / "csrc" / "rt_plan.h",)
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def nvcc_command(nvcc: str, source: Path, out: Path) -> list[str]:
    """Compile one source into the object ``out``."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(out), str(source)]


def link_command(nvcc: str, objects, out: Path) -> list[str]:
    return [nvcc, "-shared", "-o", str(out), *(str(o) for o in objects)]


def _library_path() -> Path:
    digest = hashlib.sha256()
    for source in SOURCES + HEADERS:
        digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpqmf_cached_conv_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless these sources were built already; returns
    the library's path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills per kernel, every source's) is kept beside it as
    ``.log``."""
    out = _library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen(nvcc_command(nvcc, src, obj),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(SOURCES, objects)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        logs.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{src.name}:\n{stderr[-4000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        proc = subprocess.run(link_command(nvcc, objects, tmp),
                              capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}) linking:\n"
                          f"{proc.stderr[-4000:]}")
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every C signature; pointers and the stream as c_void_p, or
    ctypes would pass them as 32-bit ints and cut them."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pqmf_analysis_conv.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.pqmf_synthesis_conv.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                        p]
    lib.pqmf_roundtrip_conv.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        i, p]
    # the tier kernels take the same arguments (their arranged banks in
    # place of the weights) and the passes (3 or 1)
    lib.pqmf_tc_analysis_conv.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                          i, p]
    lib.pqmf_tc_synthesis_conv.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                           i, i, p]
    lib.pqmf_tc_roundtrip_conv.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           i, i, i, p]
    for fn in (lib.pqmf_analysis_conv, lib.pqmf_synthesis_conv,
               lib.pqmf_roundtrip_conv, lib.pqmf_tc_analysis_conv,
               lib.pqmf_tc_synthesis_conv, lib.pqmf_tc_roundtrip_conv):
        fn.restype = ctypes.c_int
    # the plans: (which, B, M, Mb, Ka, Ks, T_out, n_sms[, passes],
    # max_clusters, plan); the gates: (which, M, Mb, Ka, Ks[, passes])
    lib.pqmf_launch_plan.argtypes = [i] * 9 + [p]
    lib.pqmf_tc_launch_plan.argtypes = [i] * 10 + [p]
    lib.pqmf_smem_bytes.argtypes = [i] * 5
    lib.pqmf_tc_smem_bytes.argtypes = [i] * 6
    for fn in (lib.pqmf_launch_plan, lib.pqmf_tc_launch_plan):
        fn.restype = ctypes.c_int
    for fn in (lib.pqmf_smem_bytes, lib.pqmf_tc_smem_bytes):
        fn.restype = ctypes.c_size_t
    # the whole-file clusters of K3 (M, Ka, Ks) and K3t (.., passes) the
    # card holds at once, into the int the last argument points to
    lib.pqmf_rt_max_clusters.argtypes = [i, i, i, p]
    lib.pqmf_tc_rt_max_clusters.argtypes = [i, i, i, i, p]
    for fn in (lib.pqmf_rt_max_clusters, lib.pqmf_tc_rt_max_clusters):
        fn.restype = ctypes.c_int
    # the pitch shifter's middle (kernels/middle.py): pointers, geometry,
    # the scales as floats
    f = ctypes.c_float
    lib.pqmf_pv_frame.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.pqmf_pv_spectral.argtypes = [p] * 5 + [i] * 4 + [f, i, p]
    lib.pqmf_pv_resynth.argtypes = [p] * 9 + [i] * 9 + [f, p]
    for fn in (lib.pqmf_pv_frame, lib.pqmf_pv_spectral, lib.pqmf_pv_resynth):
        fn.restype = ctypes.c_int
    lib.pqmf_error_string.argtypes = [i]
    lib.pqmf_error_string.restype = ctypes.c_char_p
    return bind_graph_io(lib)


def bind_graph_io(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``csrc/graph_io.cu``'s entries: the graph's 1-D copy nodes
    (graph, cap, nodes, kinds, sources, destinations, bytes, count) and a
    replay (its ``pqmf_graph_plan``, the stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pqmf_graph_copies.argtypes = [p, i, p, p, p, p, p, p]
    lib.pqmf_graph_replay.argtypes = [p, p]
    for fn in (lib.pqmf_graph_copies, lib.pqmf_graph_replay):
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib
