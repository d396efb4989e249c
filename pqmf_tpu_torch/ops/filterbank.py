"""L1 — PQMF bank construction (NumPy) and the plain tensor ops around it.

PyTorch counterpart of ``pqmf_tpu/ops/filterbank.py``. The bank build is
the JAX package's host-side NumPy, copied (importing anything from
``pqmf_tpu`` imports JAX), so the banks are bit-equal. The tensor side is
``reverse_half`` and a plain ``_conv1d``: the latter serves only the plain
versions of the conv kernels and ``streaming.streaming_conv`` /
``offline_conv``; the streaming path itself runs the kernels in
``pqmf_tpu_torch.kernels.cached_conv``.
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
    "check_precision",
    "full_f32",
]


def check_precision(precision: str) -> str:
    """Only the full-f32 ``"highest"`` tier is ported so far."""
    if precision != "highest":
        raise ValueError(
            f"precision {precision!r} is not available in pqmf_tpu_torch: "
            "only 'highest' (full f32) is ported")
    return precision


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


def _conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Cross-correlation of x [B, Cin, T] with w [Cout, Cin, L], zero
    ``padding`` (left, right), in full f32 on every device."""
    if padding != (0, 0):
        x = F.pad(x, padding)
    with full_f32():
        return F.conv1d(x, w, stride=stride)
