"""The offline PQMF's polyphase kernels K4/K5/K6: adapters over K1/K2/K3.

PyTorch counterpart of ``pqmf_tpu/kernels/polyphase.py``. The polyphase
conv is a strided dense conv on the raw signal,
``y[:, t] = W2 @ x[(t - L//2)*M : (t - L//2)*M + L*M]`` with
``W2[c, l*M + m] = hk_poly[c, m, l]``, which is the streaming path's conv
geometry. So, as in the JAX package, each public op here is an adapter over
one hand-written kernel of ``kernels/cached_conv.py``
(``csrc/cached_conv.cu``): the bank flattens to raw conv weights and the
reference's centered pads and trims become input padding:

- K4 :func:`polyphase_analysis` replaces
  ``pqmf_tpu/kernels/polyphase.py:polyphase_analysis`` and runs K1;
- K5 :func:`polyphase_synthesis` replaces
  ``pqmf_tpu/kernels/polyphase.py:polyphase_synthesis`` and runs K2;
- K6 :func:`polyphase_roundtrip` replaces
  ``pqmf_tpu/kernels/polyphase.py:polyphase_roundtrip`` and runs K3, whose
  in-kernel pads stand for K4's and K5's (no copy, no slice).

Each has a plain version (``*_plain``) built from the reference's formula in
``ops/filterbank.py`` (de-interleave, then an L-tap conv): another tap
order than the kernels', so the card check compares two formulations. A
wrapper takes its plain version only for CPU tensors; on a CUDA tensor it
runs the kernel route (``*_over_k1/k2/k3``) or raises. Every op takes the
JAX package's precision tiers by its keyword, ``mxu_precision=``, and
passes its tier on: at ``"bf16x3"`` and ``"default"`` the routes run K1t,
K2t and K3t. K4 takes ``fuse_mask`` as the JAX op does: False leaves out
the ``reverse_half`` sign mask, in K1/K1t and in the plain version. Every
launch adds one to :data:`LAUNCHES` (K1/K2/K3 count theirs in
``cached_conv.LAUNCHES``).
"""

from __future__ import annotations

import torch

from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import filterbank as fb

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "analysis_weights",
    "polyphase_analysis",
    "polyphase_synthesis",
    "polyphase_roundtrip",
    "polyphase_analysis_plain",
    "polyphase_synthesis_plain",
    "polyphase_roundtrip_plain",
    "analysis_over_k1",
    "synthesis_over_k2",
    "roundtrip_over_k3",
    "supports",
    "roundtrip_supported",
    "check_band_mesh",
]

# adapter launches since the last reset_launches(), by kernel
LAUNCHES = {"analysis": 0, "synthesis": 0, "roundtrip": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def analysis_weights(hk_poly: torch.Tensor) -> torch.Tensor:
    """K1's layout of an analysis bank: ``hk_poly`` [Mb, M, L] ->
    ``w2`` [Mb, 1, L*M] with ``w2[c, 0, l*M + m] = hk_poly[c, m, l]``.
    Built once when weights are installed, not per call."""
    Mb, M, L = hk_poly.shape
    return hk_poly.permute(0, 2, 1).reshape(Mb, 1, L * M).contiguous()


def supports(n_band: int, taps_per_phase: int,
             precision: str = "highest") -> bool:
    """Whether K1 and K2 take a polyphase bank of ``taps_per_phase`` (L)
    taps per phase: K4 runs K1 with L*M taps, K5 runs K2 with L."""
    return cc.supports(n_band, taps_per_phase * n_band, taps_per_phase,
                       precision)


def roundtrip_supported(n_band: int, analysis_taps: int,
                        synthesis_taps: int,
                        precision: str = "highest") -> bool:
    """Whether K6 runs (K3 takes the geometry): the port's gate
    ``cached_conv.fused_roundtrip_supported`` — true for every committed
    bank, M = 2 to 64, as the JAX gate is from M = 8 on (at M = 2 and 4 the
    JAX gate's 128-lane grouping of the synthesis pad refuses, a TPU
    layout constraint K3 does not have); past this gate the round trip
    runs K4 then K5."""
    return cc.fused_roundtrip_supported(n_band, analysis_taps,
                                        synthesis_taps, precision)


def check_band_mesh(mesh, n_band: int):
    """Validate a (data, band) mesh (a 2-D ``DeviceMesh``) for the
    band-partitioned kernels: two dims, and a band dim that splits
    ``n_band`` into even shards (the fused ``reverse_half`` sign mask reads
    the local band index, whose parity must equal the global one). Returns
    the mesh (or None), so callers can store the validated value. The JAX
    package's ``check_band_mesh`` (``pqmf_tpu/kernels/polyphase.py:82``)."""
    if mesh is None:
        return None
    ndim = getattr(mesh, "ndim", None)
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if ndim != 2 or len(names) != 2:
        raise ValueError(
            f"expected a 2-axis (data, band) mesh, got {ndim} dim(s) "
            f"named {names}")
    band = mesh.size(1)
    if n_band % band or (n_band // band) % 2:
        raise ValueError(
            f"band axis size {band} must divide n_band={n_band} "
            f"into even shards for the band-partitioned kernels")
    return mesh


# ---------------------------------------------------------------------------
# plain versions: the reference's polyphase formula
# ---------------------------------------------------------------------------


def polyphase_analysis_plain(x, hk_poly, precision: str = "highest",
                             fuse_mask: bool = True):
    """Plain K4: ``reverse_half(polyphase_forward(x, hk_poly))``, or
    without ``reverse_half`` when ``fuse_mask`` is False."""
    y = fb.polyphase_forward(x, hk_poly, precision)
    return fb.reverse_half(y) if fuse_mask else y


def polyphase_synthesis_plain(x, hk_ipoly, precision: str = "highest"):
    """Plain K5: ``polyphase_inverse(reverse_half(x), hk_ipoly)``."""
    return fb.polyphase_inverse(fb.reverse_half(x), hk_ipoly, precision)


def polyphase_roundtrip_plain(x, hk_poly, hk_ipoly,
                              precision: str = "highest"):
    """Plain K6: plain K5 of plain K4 (the two sign masks cancel; at a tier
    the f32 sub-bands are split again)."""
    return polyphase_synthesis_plain(
        polyphase_analysis_plain(x, hk_poly, precision), hk_ipoly,
        precision)


# ---------------------------------------------------------------------------
# the kernel routes: pads and layouts around K1/K2/K3 (on CPU tensors the
# K1/K2/K3 wrappers run their own plain versions, so the tests hold these
# routes against the formulas above)
# ---------------------------------------------------------------------------


def _analysis_pad(M: int, L: int) -> tuple:
    """The centered polyphase pad as input padding: window t starts at
    (t - L//2)*M, and the last window ends at T + (L - L//2 - 1)*M."""
    return (L // 2) * M, (L - L // 2 - 1) * M


def analysis_over_k1(x, w2, M: int, precision: str = "highest",
                     tc_bank=None, fuse_mask: bool = True):
    """K4's route: K1 with the centered pad, which K1 applies while it
    copies its window (the padded signal is never written), and the sign
    mask unless ``fuse_mask`` is False. x [B, 1, T]; w2 [Mb, 1, L*M]
    (:func:`analysis_weights`); at a tier K1t reads ``tc_bank``
    (``cached_conv.arrange_tc_bank(w2, "analysis", tier)``) where the
    caller keeps one. Returns [B, Mb, T/M]."""
    L = w2.shape[-1] // M
    return cc.strided_analysis_conv(x, w2, M, fuse_mask,
                                    pad=_analysis_pad(M, L),
                                    mxu_precision=precision, bank=tc_bank)


def synthesis_over_k2(x, hk_ipoly, precision: str = "highest",
                      tc_bank=None):
    """K5's route: K2 with the pad (L//2-1, L-L//2), the reference's pad
    L//2+1, ``[..., :-1]`` trim and 2-row delay trim in one, applied by K2
    while it copies its window (the padded sub-bands are never written);
    the input mask's parity is the sub-band time. x [B, Mb, T'];
    hk_ipoly [M, Mb, L]; at a tier K2t reads ``tc_bank``
    (``arrange_tc_bank(hk_ipoly, "synthesis", tier)``) where the caller
    keeps one. Returns [B, 1, M*T']."""
    B, _, Tp = x.shape
    M, L = hk_ipoly.shape[0], hk_ipoly.shape[-1]
    off = L // 2 - 1
    out = cc.dense_synthesis_conv(x.contiguous(), hk_ipoly, x_offset=0,
                                  mxu_precision=precision,
                                  pad=(off, L - 1 - off),
                                  bank=tc_bank)  # [B, T', M]
    return out.reshape(B, 1, Tp * M)


def roundtrip_over_k3(x, w2, hk_ipoly, M: int, precision: str = "highest",
                      tc_banks=None):
    """K6's route: K3 with K4's centered pad on the signal and K5's pad
    (L//2-1, L-L//2) on the sub-bands, both applied by K3 while it copies
    its windows: its output is K5(K4(x))'s, step for step, and no padded
    copy or slice is written. x [B, 1, T]; at a tier K3t reads
    ``tc_banks`` = (``arrange_tc_bank(w2, "analysis", tier)``,
    ``arrange_tc_bank(hk_ipoly, "synthesis", tier)``) where the caller
    keeps them. Returns [B, 1, T]."""
    B, _, T = x.shape
    L = w2.shape[-1] // M
    Ls = hk_ipoly.shape[-1]
    off = Ls // 2 - 1
    out = cc.fused_roundtrip_conv(x.contiguous(), w2, hk_ipoly, M,
                                  (off, Ls - 1 - off), precision,
                                  pad=_analysis_pad(M, L), banks=tc_banks)
    return out.reshape(B, 1, T)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_signal(x, M: int):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.ndim != 3 or x.shape[1] != 1:
        raise ValueError(f"x must be [B, 1, T], got {tuple(x.shape)}")
    if x.shape[-1] % M:
        raise ValueError(f"T={x.shape[-1]} must be divisible by M={M}")


def polyphase_analysis(x, hk_poly, w2=None, fuse_mask: bool = True,
                       mxu_precision: str = "highest", tc_bank=None):
    """K4 — offline polyphase analysis plus the fused ``reverse_half``
    (left out when ``fuse_mask`` is False).

    x: [B, 1, T] (T divisible by M); hk_poly: [Mb, M, L]; ``w2`` is
    ``analysis_weights(hk_poly)`` and ``tc_bank`` its arrangement for K1t
    at a tier, when the caller keeps them. Returns [B, Mb, T/M], equal to
    ``reverse_half(polyphase_forward(x, hk_poly))``."""
    M = hk_poly.shape[1]
    _check_signal(x, M)
    if x.device.type == "cpu":
        return polyphase_analysis_plain(x, hk_poly, mxu_precision,
                                        fuse_mask)
    if w2 is None:
        w2 = analysis_weights(hk_poly)
    out = analysis_over_k1(x, w2, M, mxu_precision, tc_bank, fuse_mask)
    LAUNCHES["analysis"] += 1
    return out


def polyphase_synthesis(x, hk_ipoly, mxu_precision: str = "highest",
                        tc_bank=None):
    """K5 — ``reverse_half`` plus offline polyphase synthesis.

    x: [B, Mb, T'] sub-bands; hk_ipoly: [M, Mb, L], contiguous; ``tc_bank``
    its arrangement for K2t at a tier, when the caller keeps one. Returns
    [B, 1, M*T'], equal to ``polyphase_inverse(reverse_half(x), hk_ipoly)``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x)}")
    if x.ndim != 3:
        raise ValueError(f"x must be [B, Mb, T'], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return polyphase_synthesis_plain(x, hk_ipoly, mxu_precision)
    out = synthesis_over_k2(x, hk_ipoly, mxu_precision, tc_bank)
    LAUNCHES["synthesis"] += 1
    return out


def polyphase_roundtrip(x, hk_poly, hk_ipoly, w2=None,
                        mxu_precision: str = "highest", tc_banks=None):
    """K6 — analysis -> synthesis in one kernel (K3): the sub-bands stay in
    shared memory and the two masks cancel. Equal to
    ``polyphase_synthesis(polyphase_analysis(x, hk_poly), hk_ipoly)`` up to
    f32 round-off (another tap order). Full bank only (hk_poly [M, M, L]);
    gate with :func:`roundtrip_supported`. ``tc_banks`` is the pair of
    arranged banks K3t reads at a tier, when the caller keeps them
    (``PQMF.tc_banks``). x: [B, 1, T] -> [B, 1, T]."""
    M = hk_poly.shape[1]
    _check_signal(x, M)
    if x.device.type == "cpu":
        return polyphase_roundtrip_plain(x, hk_poly, hk_ipoly, mxu_precision)
    if w2 is None:
        w2 = analysis_weights(hk_poly)
    out = roundtrip_over_k3(x, w2, hk_ipoly, M, mxu_precision, tc_banks)
    LAUNCHES["roundtrip"] += 1
    return out
