"""The streaming path's three conv kernels, their plain versions and gates.

Each public function here is the wrapper of one hand-written Hopper kernel
in ``pqmf_tpu_torch/csrc/cached_conv.cu`` (built and bound by ``_build``):

- K1 :func:`strided_analysis_conv` replaces
  ``pqmf_tpu/kernels/cached_conv.py:strided_analysis_conv``;
- K2 :func:`dense_synthesis_conv` replaces
  ``pqmf_tpu/kernels/cached_conv.py:dense_synthesis_conv``;
- K3 :func:`fused_roundtrip_conv` replaces
  ``pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv``.

All three compute VALID convolutions in f32 of inputs the caller has already
padded, so offline (centered), causal and streaming modes share them. What
bounds each kernel on the H100 and what its design does about it is written
at the top of the CUDA source: they are f32 FMA on the CUDA cores, bound by
arithmetic and shared-memory bandwidth, and reuse a staged input window and
bank from shared memory with several outputs per thread in registers.

A wrapper takes its kernel's plain PyTorch version (``*_plain``, on
``F.conv1d`` in full f32) only for CPU tensors. On a CUDA tensor it launches
the kernel or raises; no shape falls back to the plain version there. Every
launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from pqmf_tpu_torch.ops import filterbank as fb

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "strided_analysis_conv",
    "dense_synthesis_conv",
    "fused_roundtrip_conv",
    "analysis_conv_plain",
    "synthesis_conv_plain",
    "roundtrip_conv_plain",
    "supports",
    "fused_roundtrip_supported",
    "smem_bytes",
]

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"analysis": 0, "synthesis": 0, "roundtrip": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# gates: shared memory per block, mirroring pqmf_smem_bytes in the CUDA
# source (the card check compares the two)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_R = 4                       # kR
_ANA_TT = 16 * _R            # kAnaGroups * kR
_SYN_TT = 16 * _R            # kSynGroups * kR
_RT_TT = 32 * _R             # kRtGroups * kR
_WEIGHT_BYTES = 64 * 1024    # kWeightBytes


def _odd(n: int) -> int:
    return n | 1


def smem_bytes(which: str, M: int, Mb: int, Ka: int, Ks: int) -> int:
    """Shared memory one block of kernel ``which`` ("analysis",
    "synthesis", "roundtrip") needs; Ka/Ks are the analysis/synthesis
    kernel lengths (the other one is ignored)."""
    if which == "analysis":
        cb = max(1, min(Mb, _WEIGHT_BYTES // (4 * _odd(Ka))))
        return 4 * (cb * _odd(Ka) + (_ANA_TT - 1) * M + Ka)
    if which == "synthesis":
        cc = max(1, min(M, _WEIGHT_BYTES // (4 * _odd(Mb * Ks))))
        return 4 * (cc * _odd(Mb * Ks) + Mb * (_SYN_TT + Ks - 1))
    if which == "roundtrip":
        sub_len = -(-(_RT_TT + Ks - 1) // _R) * _R
        return 4 * (M * _odd(Ka) + M * _odd(M * Ks) + M * sub_len
                    + (sub_len - 1) * M + Ka)
    raise ValueError(f"unknown kernel {which!r}")


def supports(n_band: int, analysis_taps: int, synthesis_taps: int) -> bool:
    """Whether K1 and K2 take a full bank of this geometry: K1 and K2 stage
    a chunk of the bank (at least one band or phase) and their input window
    in one block's shared memory. Any band count whose banks fit is
    admitted; the TPU's 128-lane halo limit does not apply here."""
    M = n_band
    return (M >= 1
            and smem_bytes("analysis", M, M, analysis_taps, 0) <= SMEM_LIMIT
            and smem_bytes("synthesis", M, M, 0, synthesis_taps)
            <= SMEM_LIMIT)


def fused_roundtrip_supported(M: int, analysis_taps: int,
                              synthesis_taps: int) -> bool:
    """Whether K3 takes this geometry: both full banks, the input window
    and the sub-band tile fit in one block's shared memory (true for the
    atten-100 banks up to M=16; M=32 is past it and its round trip runs
    as K1 then K2)."""
    return (M >= 2 and smem_bytes("roundtrip", M, M, analysis_taps,
                                  synthesis_taps) <= SMEM_LIMIT)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def analysis_conv_plain(x, w, M: int, fuse_mask: bool = True):
    """Plain K1: ``reverse_half(conv1d(x, w, stride=M))`` -> [B, Mb, T_out]."""
    y = fb._conv1d(x, w, stride=M)
    return fb.reverse_half(y) if fuse_mask else y


def synthesis_conv_plain(x, w, fuse_mask: bool = True, x_offset: int = 0):
    """Plain K2: sign mask on the input (parity from ``x_offset``, the
    position of x[..., 0] in the unpadded signal), conv, ``*M``, band flip,
    time-major [B, T_out, M]."""
    M = w.shape[0]
    if fuse_mask:
        x = fb.reverse_half(x, offset=x_offset)
    y = fb._conv1d(x, w) * M
    return torch.flip(y, dims=(1,)).transpose(1, 2).contiguous()


def roundtrip_conv_plain(x, w_ana, w_syn, M: int, syn_pad):
    """Plain K3: plain K1, zero pad ``syn_pad``, plain K2 — with both sign
    masks, the synthesis mask's parity taken from the sub-band signal."""
    sub = analysis_conv_plain(x, w_ana, M, fuse_mask=True)
    sub = torch.nn.functional.pad(sub, tuple(syn_pad))
    return synthesis_conv_plain(sub, w_syn, fuse_mask=True,
                                x_offset=-syn_pad[0])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name, t, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, *args):
    """Call a C entry on the current stream of the inputs' card and raise
    on a non-zero cudaError_t."""
    from pqmf_tpu_torch.kernels import _build

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(
            f"{fn} failed: {lib.pqmf_error_string(err).decode()} ({err})")


def strided_analysis_conv(x, w, M: int, fuse_mask: bool = True):
    """K1 — valid stride-M conv of a pre-padded mono signal plus the fused
    ``reverse_half`` on the output.

    x: [B, 1, Tpad]; w: [Mb, 1, K]. Returns [B, Mb, T_out] with
    ``T_out = (Tpad - K) // M + 1``."""
    dev = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, 3, dev)
    _check("w", w, 3, dev)
    B, C, Tpad = x.shape
    Mb, Cw, K = w.shape
    if C != 1 or Cw != 1:
        raise ValueError(f"analysis is mono: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if fuse_mask and Mb % 2:
        raise ValueError("band shards must be even-sized (sign-mask parity)")
    T_out = (Tpad - K) // M + 1
    if B < 1 or T_out < 1:
        raise ValueError(f"empty analysis output: B={B}, Tpad={Tpad}, K={K}")
    if dev.type == "cpu":
        return analysis_conv_plain(x, w, M, fuse_mask)
    if smem_bytes("analysis", M, Mb, K, 0) > SMEM_LIMIT:
        raise ValueError(f"analysis kernel length {K} exceeds the kernel's "
                         "shared memory; gate with supports()")
    out = torch.empty((B, Mb, T_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("pqmf_analysis_conv", x.data_ptr(), w.data_ptr(),
                out.data_ptr(), B, Tpad, M, Mb, K, T_out, int(fuse_mask))
    LAUNCHES["analysis"] += 1
    return out


def dense_synthesis_conv(x, w, fuse_mask: bool = True, x_offset: int = 0):
    """K2 — valid stride-1 M->M conv of pre-padded sub-bands with the
    synthesis post-amble fused: optional ``reverse_half`` on the input
    (``x_offset`` = index of x[..., 0] in the unpadded signal), ``*M``
    gain, band flip, and time-major output so the phase interleave is a
    free reshape.

    x: [B, Mb, Tpad]; w: [M, Mb, K]. Returns [B, T_out, M] with
    ``T_out = Tpad - K + 1``."""
    dev = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, 3, dev)
    _check("w", w, 3, dev)
    B, Mb, Tpad = x.shape
    M, Mw, K = w.shape
    if Mw != Mb:
        raise ValueError(f"band dims disagree: x has {Mb}, bank has {Mw}")
    if fuse_mask and Mb % 2:
        raise ValueError("band shards must be even-sized (sign-mask parity)")
    T_out = Tpad - K + 1
    if B < 1 or T_out < 1:
        raise ValueError(f"empty synthesis output: B={B}, Tpad={Tpad}, K={K}")
    if dev.type == "cpu":
        return synthesis_conv_plain(x, w, fuse_mask, x_offset)
    if smem_bytes("synthesis", M, Mb, 0, K) > SMEM_LIMIT:
        raise ValueError(f"synthesis bank [{M}, {Mb}, {K}] exceeds the "
                         "kernel's shared memory; gate with supports()")
    out = torch.empty((B, T_out, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("pqmf_synthesis_conv", x.data_ptr(), w.data_ptr(),
                out.data_ptr(), B, Mb, Tpad, M, K, T_out, int(fuse_mask),
                int(x_offset))
    LAUNCHES["synthesis"] += 1
    return out


def fused_roundtrip_conv(x, w_ana, w_syn, M: int, syn_pad):
    """K3 — analysis -> zero pad ``syn_pad`` -> synthesis in one kernel;
    the sub-band intermediate stays in shared memory and the two
    ``reverse_half`` masks cancel, so neither is applied.

    x: [B, 1, Tpad] pre-padded for the analysis; w_ana: [M, 1, Ka];
    w_syn: [M, M, Ks]; syn_pad = (left, right) >= 0. Returns
    [B, T_out, M] with ``T_out = left + T_ana + right - Ks + 1``, equal to
    :func:`roundtrip_conv_plain`."""
    dev = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, 3, dev)
    _check("w_ana", w_ana, 3, dev)
    _check("w_syn", w_syn, 3, dev)
    B, C, Tpad = x.shape
    Ka, Ks = w_ana.shape[-1], w_syn.shape[-1]
    if (C != 1 or tuple(w_ana.shape[:2]) != (M, 1)
            or tuple(w_syn.shape[:2]) != (M, M)):
        raise ValueError("fused round trip is mono and full-bank only: x "
                         f"{tuple(x.shape)}, w_ana {tuple(w_ana.shape)}, "
                         f"w_syn {tuple(w_syn.shape)}, M={M}")
    pad_l, pad_r = (int(p) for p in syn_pad)
    if pad_l < 0 or pad_r < 0:
        raise ValueError(f"syn_pad must be non-negative, got {syn_pad}")
    T_ana = (Tpad - Ka) // M + 1
    T_out = pad_l + T_ana + pad_r - Ks + 1
    if B < 1 or T_ana < 1 or T_out < 1:
        raise ValueError(f"empty round trip: B={B}, Tpad={Tpad}")
    if dev.type == "cpu":
        return roundtrip_conv_plain(x, w_ana, w_syn, M, (pad_l, pad_r))
    if not fused_roundtrip_supported(M, Ka, Ks):
        raise ValueError(f"fused round trip of M={M}, Ka={Ka}, Ks={Ks} "
                         "exceeds the kernel's shared memory; gate with "
                         "fused_roundtrip_supported()")
    out = torch.empty((B, T_out, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("pqmf_roundtrip_conv", x.data_ptr(), w_ana.data_ptr(),
                w_syn.data_ptr(), out.data_ptr(), B, Tpad, M, Ka, Ks, T_ana,
                T_out, pad_l)
    LAUNCHES["roundtrip"] += 1
    return out
