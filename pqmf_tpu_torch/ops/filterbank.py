"""L1 — PQMF bank construction (NumPy) and the plain tensor ops around it.

PyTorch counterpart of ``pqmf_tpu/ops/filterbank.py``. The bank build is
the JAX package's host-side NumPy, copied (importing anything from
``pqmf_tpu`` imports JAX), so the banks are bit-equal. The tensor side is
``reverse_half``, a plain ``_conv1d`` at the three precision tiers and, on
it, the offline polyphase and classic analysis/synthesis with the
reference's exact edge semantics. ``_conv1d`` serves the plain versions of
the conv kernels,
``streaming.streaming_conv`` / ``offline_conv`` and the classic path; the
polyphase ops are the plain versions of K4/K5/K6
(``pqmf_tpu_torch.kernels.polyphase``), whose CUDA route runs the kernels
in ``pqmf_tpu_torch.kernels.cached_conv``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch import design

__all__ = [
    "reverse_half",
    "center_pad_next_pow_2",
    "make_odd",
    "get_qmf_bank",
    "build_filterbank",
    "params_from_hk",
    "polyphase_forward",
    "polyphase_inverse",
    "classic_forward",
    "classic_inverse",
    "PRECISIONS",
    "check_precision",
    "split_bf16",
    "full_f32",
]

# the conv tiers of the JAX package's kernels (``mxu_precision=``):
# "highest" full f32; "bf16x3" the split-operand three-pass sum hi*hi +
# hi*lo + lo*hi with f32 sums; "default" one pass over the bf16 hi halves
PRECISIONS = ("highest", "bf16x3", "default")


def check_precision(precision: str) -> str:
    """``precision`` if it names a tier of :data:`PRECISIONS`, else
    ``ValueError``."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}: expected one of "
            f"{', '.join(repr(p) for p in PRECISIONS)}")
    return precision


def split_bf16(a: torch.Tensor):
    """The hi + lo bf16 halves of an f32 tensor, as f32 values: hi =
    bf16(a) and lo = bf16(a - hi), each rounded to nearest even (the JAX
    package's ``_split_bf16``, ``pqmf_tpu/kernels/cached_conv.py:85``). A
    product of two halves is exact in f32."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    lo = (a - hi).to(torch.bfloat16).to(a.dtype)
    return hi, lo


@contextlib.contextmanager
def full_f32():
    """Run cuDNN convolutions and cuBLAS matmuls in full f32 — the
    ``highest`` tier. cuDNN's f32 convolutions default to TF32 on the card
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; the previous settings are restored on exit."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


# ---------------------------------------------------------------------------
# Host-side bank construction (NumPy; runs once at module build time)
# ---------------------------------------------------------------------------


def get_qmf_bank(h: np.ndarray, n_band: int) -> np.ndarray:
    """Cosine-modulate prototype ``h`` into ``n_band`` filters
    (reference: pqmf.py:44-63):
    ``hk[k, t] = 2 h[t] cos((2k+1) pi/(2M) t' + (-1)^k pi/4)`` with
    ``t' in [-N//2, N//2]``.
    """
    h = np.asarray(h, dtype=np.float32)
    k = np.arange(n_band).reshape(-1, 1)
    N = h.shape[-1]
    t = np.arange(-(N // 2), N // 2 + 1)
    p = (-1.0) ** k * math.pi / 4
    mod = np.cos((2 * k + 1) * math.pi / (2 * n_band) * t + p)
    return (2 * h * mod).astype(np.float32)


def center_pad_next_pow_2(x: np.ndarray) -> np.ndarray:
    """Center-pad the last dim to the next power of two; if the pad is odd
    the extra sample goes on the right (reference: pqmf.py:26-32)."""
    next_2 = 2 ** math.ceil(math.log2(x.shape[-1]))
    pad = next_2 - x.shape[-1]
    widths = [(0, 0)] * (x.ndim - 1) + [(pad // 2, pad // 2 + pad % 2)]
    return np.pad(x, widths)


def make_odd(x: np.ndarray) -> np.ndarray:
    """Right-pad the last dim by one zero if its length is even
    (reference: pqmf.py:35-41)."""
    if x.shape[-1] % 2 == 0:
        widths = [(0, 0)] * (x.ndim - 1) + [(0, 1)]
        x = np.pad(x, widths)
    return x


def build_filterbank(attenuation: float, n_band: int) -> dict:
    """Run the full design chain (reference: pqmf.py:216-231) and return all
    derived filter arrays (NumPy float32):

    - ``h``        [N]            prototype
    - ``hk``       [M, P]         modulated bank, center-padded to pow2 P
    - ``hk_poly``  [M, M, P/M]    analysis polyphase matrix
                                  (rearrange "c (t m) -> c m t")
    - ``hk_ipoly`` [M, M, P/M]    synthesis polyphase matrix
                                  (time-flipped, rearrange "c (t m) -> m c t")
    """
    h = design.get_prototype(attenuation, n_band)
    h = h.astype(np.float32)
    hk = center_pad_next_pow_2(get_qmf_bank(h, n_band))
    return params_from_hk(hk, h=h)


def params_from_hk(hk, h=None) -> dict:
    """Derive the params dict from a given modulated bank ``hk`` [M, P] —
    e.g. a fine-tuned bank that is no longer exactly a cosine modulation
    of one prototype. ``h`` (the prototype) is carried through when known,
    else stored empty. The polyphase matrices need ``P % M == 0``; for
    other band counts they are stored empty."""
    hk = np.asarray(hk, np.float32)
    M, P = hk.shape
    h = np.zeros((0,), np.float32) if h is None else np.asarray(h, np.float32)
    if P % M:
        empty = np.zeros((M, M, 0), np.float32)
        return {"h": h, "hk": hk, "hk_poly": empty,
                "hk_ipoly": empty.copy()}
    hk_poly = hk.reshape(M, P // M, M).transpose(0, 2, 1)
    hk_flip = hk[:, ::-1]
    hk_ipoly = hk_flip.reshape(M, P // M, M).transpose(2, 0, 1)
    return {"h": h, "hk": hk, "hk_poly": np.ascontiguousarray(hk_poly),
            "hk_ipoly": np.ascontiguousarray(hk_ipoly)}


# ---------------------------------------------------------------------------
# Plain tensor ops
# ---------------------------------------------------------------------------


def reverse_half(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Alias-cancellation sign mask (reference: pqmf.py:13-22): negate even
    time samples of odd sub-bands (``mask[..., 1::2, ::2] = -1``).
    ``offset`` is the position of ``x[..., 0]`` in the signal whose sample
    parity counts (a padded window's column 0 sits at minus its pad)."""
    M, T = x.shape[-2], x.shape[-1]
    mask = torch.ones((M, T), dtype=x.dtype, device=x.device)
    mask[1::2, offset % 2::2] = -1.0
    return x * mask


def _tier_sum(fn, a: torch.Tensor, b: torch.Tensor,
              precision: str) -> torch.Tensor:
    """A bilinear ``fn`` at a tier over the :func:`split_bf16` halves:
    fn(ah, bh) + fn(ah, bl) + fn(al, bh) at ``"bf16x3"``, fn(ah, bh) at
    ``"default"``."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    y = fn(ah, bh)
    if precision == "bf16x3":
        y = y + fn(ah, bl) + fn(al, bh)
    return y


class _TierConv(torch.autograd.Function):
    """The tier conv with XLA's transpose rule for its gradients: both
    transposed convs run at the forward's tier over split operands, the
    cotangent split like the other operand (autograd through
    :func:`split_bf16` would round the cotangent to bf16 and drop the
    tier's lo terms)."""

    @staticmethod
    def forward(ctx, x, w, stride, precision):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.precision = stride, precision
        with full_f32():
            return _tier_sum(lambda a, b: F.conv1d(a, b, stride=stride), x,
                             w, precision)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, precision = ctx.stride, ctx.precision
        grad = torch.nn.grad
        gx = gw = None
        with full_f32():
            if ctx.needs_input_grad[0]:
                gx = _tier_sum(lambda c, k: grad.conv1d_input(
                    x.shape, k, c, stride), g, w, precision)
            if ctx.needs_input_grad[1]:
                gw = _tier_sum(lambda a, c: grad.conv1d_weight(
                    a, w.shape, c, stride), x, g, precision)
        return gx, gw, None, None


def _conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding: tuple[int, int] = (0, 0),
            precision: str = "highest") -> torch.Tensor:
    """Cross-correlation of x [B, Cin, T] with w [Cout, Cin, L], zero
    ``padding`` (left, right), at a precision tier on every device:
    ``"highest"`` one f32 conv; ``"bf16x3"`` conv(xh, wh) + conv(xh, wl) +
    conv(xl, wh) over the :func:`split_bf16` halves; ``"default"``
    conv(xh, wh). The convs run in full f32: a product of bf16 values is
    exact there, so this is the TPU tier up to the order of summation
    (TF32 would add error of its own).

    Differentiable: at ``"highest"`` autograd differentiates ``F.conv1d``
    (its backward convs run after :func:`full_f32` has exited, so a
    caller on the card runs ``backward()`` inside it); at the tiers
    ``_TierConv`` computes both gradients at the tier, in full f32."""
    check_precision(precision)
    if padding != (0, 0):
        x = F.pad(x, padding)
    if precision != "highest":
        return _TierConv.apply(x, w, stride, precision)
    with full_f32():
        return F.conv1d(x, w, stride=stride)


def polyphase_forward(x: torch.Tensor, hk_poly: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """Fast polyphase analysis (reference: pqmf.py:115-130).

    x: [B, 1, T] with T divisible by M; hk_poly: [Mb, M, L].
    Returns [B, Mb, T/M]."""
    B, C, T = x.shape
    M, L = hk_poly.shape[1], hk_poly.shape[-1]
    # "b c (t m) -> b (c m) t": phase index m is the fast axis of time
    xp = x.reshape(B, C, T // M, M).transpose(-1, -2).reshape(B, C * M,
                                                              T // M)
    return _conv1d(xp, hk_poly, padding=(L // 2, L // 2),
                   precision=precision)[..., :-1]


def polyphase_inverse(x: torch.Tensor, hk_ipoly: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """Fast polyphase synthesis (reference: pqmf.py:133-157).

    x: [B, Mb, T'] sub-bands; hk_ipoly: [M, Mb, L]. Returns [B, 1, M*T']."""
    M, L = hk_ipoly.shape[0], hk_ipoly.shape[-1]
    pad = L // 2 + 1
    y = _conv1d(x, hk_ipoly, padding=(pad, pad),
                precision=precision)[..., :-1] * M
    y = torch.flip(y, dims=(1,))  # band-order reversal
    # drop the first 2 polyphase rows == the reference's ``x[..., 2*M:]``
    # trim after the interleave (pqmf.py:156)
    y = y[..., 2:]
    B, _, Tp = y.shape
    # "b (c m) t -> b c (t m)": interleave phases back into time
    return y.transpose(1, 2).reshape(B, 1, Tp * M)


def classic_forward(x: torch.Tensor, hk: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """Slow full-rate analysis (reference: pqmf.py:160-177).

    x: [B, 1, T]; hk: [M, P]. Returns [B, M, T/M]."""
    M, P = hk.shape
    return _conv1d(x, hk[:, None, :], stride=M, padding=(P // 2, P // 2),
                   precision=precision)[..., :-1]


def classic_inverse(x: torch.Tensor, hk: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """Slow synthesis via zero-stuffing (reference: pqmf.py:180-199): each
    band is zero-stuffed to full rate (``y[..., ::M] = x*M``, M*T' samples
    including the M-1 trailing zeros) and convolved with the time-flipped
    bank summed over bands, padded (P//2-1, P//2) so the output equals the
    reference's ``conv1d(pad=P//2)[..., 1:]``. (The JAX package stuffs with
    ``lhs_dilation=M``, whose dilated input lacks those trailing zeros and
    so pads M-1 more on the right.)

    x: [B, M, T']; hk: [M, P]. Returns [B, 1, M*T']."""
    M, P = hk.shape
    B, _, Tp = x.shape
    y = x.new_zeros((B, M, Tp * M))
    y[..., ::M] = x * M
    w = torch.flip(hk, dims=(-1,))[None]  # [1, M, P]
    return _conv1d(y, w, padding=(P // 2 - 1, P // 2), precision=precision)
