"""L2 — streaming PQMF with explicit state, on the hand-written kernels.

PyTorch counterpart of ``pqmf_tpu/streaming.py``: the reference's
``CachedPQMF`` (pqmf.py:306-354) as convolutions whose centered padding is
replaced, in streaming mode, by a carried buffer of past input samples, so
that block-wise calls reproduce the causal offline output exactly:

    state', y = streaming_conv(state, x, w, stride)

with the state dict owned by the caller. Concatenated block outputs equal
the causal offline conv for any partition whose per-block SUB-BAND length
is even (``reverse_half``'s block-local sign; see
:meth:`StreamingPQMF._check_block_parity`).

Every conv of :class:`StreamingPQMF` goes through the kernel wrappers in
:mod:`pqmf_tpu_torch.kernels.cached_conv`: on a CUDA device the analysis
runs K1, the synthesis K2 and :meth:`StreamingPQMF.roundtrip` K3; on the
CPU the same wrappers run their plain versions.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import filterbank as fb

__all__ = [
    "centered_padding",
    "streaming_conv",
    "offline_conv",
    "conv_state_init",
    "kernels_from_params",
    "resolve_device",
    "StreamingPQMF",
]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none
    (never a silent run on the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: 'cpu' or 'cuda'")
    if dev.type == "cuda" and dev.index is None:
        # tensors report their card's index: "cuda" means the current one
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _on(v, device) -> torch.Tensor:
    """A contiguous float32 copy of array or tensor ``v`` on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device, torch.float32).contiguous()
    return torch.tensor(np.asarray(v, np.float32), device=device)


def kernels_from_params(params, device="cpu") -> tuple:
    """The streaming conv kernels of a filterbank params dict (designed or
    fine-tuned): analysis ``make_odd(hk)[:, None, :]`` ([M, 1, P(+1)])
    and synthesis ``make_odd(hk_ipoly)`` ([M, M, L(+1)]) — the CachedPQMF
    geometry, reference pqmf.py:316-333."""
    hkf = fb.make_odd(_np32(params["hk"]))[:, None, :]
    hki = fb.make_odd(_np32(params["hk_ipoly"]))
    return _on(hkf, device), _on(hki, device)


def centered_padding(kernel: int) -> tuple[int, int]:
    """Centered padding of the reference's exported convs: ``(K//2, K//2)``
    for the odd ``make_odd`` kernels.

    The reference builds both cached convs with ``cc.get_padding(K)`` and
    never passes the stride (pqmf.py:316-333), so the strided analysis is
    padded as if the stride were 1: ``(256, 256)`` for K=513/stride=16,
    not the stride-aware ``(248, 249)``, which is an 8-sample grid shift
    (about 2 dB against the reference artifact)."""
    total = kernel - 1
    return total // 2, total - total // 2


def conv_state_init(batch: int, in_ch: int, kernel: int, stride: int,
                    device="cpu") -> torch.Tensor:
    """Zero cache of the ``kernel - stride`` past input samples."""
    return torch.zeros((batch, in_ch, kernel - stride), dtype=torch.float32,
                       device=device)


def streaming_conv(state, x, w, stride: int = 1):
    """One streaming step of a cached Conv1d (plain, full f32).

    state: [B, Cin, K-S] carried past samples; x: [B, Cin, T] (T % S == 0);
    w: [Cout, Cin, K]. Returns (state', y [B, Cout, T/S])."""
    K = w.shape[-1]
    xx = torch.cat([state, x], dim=-1)
    y = fb._conv1d(xx, w, stride=stride)
    return xx[..., xx.shape[-1] - (K - stride):], y


def offline_conv(x, w, stride: int = 1, causal: bool = False):
    """Offline reference for the streaming property: centered (the
    reference's exported non-cached mode) or causal (what streaming
    reproduces from zero initial state)."""
    K = w.shape[-1]
    pad = (K - stride, 0) if causal else centered_padding(K)
    return fb._conv1d(x, w, stride=stride, padding=pad)


def _cached_analysis(x, hkf, state, mode="offline"):
    """CachedPQMF.forward (pqmf.py:339-343): strided 1->M conv and sign
    mask, as K1 over the mode's padded input. Returns (state', y)."""
    M, _, K = hkf.shape
    if mode == "offline":
        xx = F.pad(x, centered_padding(K))
        new_state = state
    elif mode == "causal":
        xx = F.pad(x, (K - M, 0))
        new_state = state
    else:  # streaming
        xx = torch.cat([state, x], dim=-1)
        new_state = xx[..., xx.shape[-1] - (K - M):]
    return new_state, cc.strided_analysis_conv(xx, hkf, M)


def _cached_synthesis(x, hki, state, mode="offline"):
    """CachedPQMF.inverse (pqmf.py:345-354): sign mask, M->M conv * M, band
    flip, phase interleave, as K2 over the mode's padded input. Returns
    (state', y [B, 1, T'*M])."""
    M, _, K = hki.shape
    if mode == "offline":
        sl, sr = centered_padding(K)
        y = cc.dense_synthesis_conv(F.pad(x, (sl, sr)), hki, x_offset=-sl)
        new_state = state
    elif mode == "causal":
        y = cc.dense_synthesis_conv(F.pad(x, (K - 1, 0)), hki,
                                    x_offset=-(K - 1))
        new_state = state
    else:
        # block-local sign mask first: the carried tail keeps the previous
        # block's masked samples
        xx = torch.cat([state, fb.reverse_half(x)], dim=-1)
        new_state = xx[..., xx.shape[-1] - (K - 1):]
        y = cc.dense_synthesis_conv(xx, hki, fuse_mask=False)
    return new_state, y.reshape(y.shape[0], 1, -1)


class StreamingPQMF:
    """Streaming PQMF with explicit state, on one device.

    ``n_channels > 1`` folds channels into the batch of the mono conv
    core: ``forward`` maps [B, C, T] -> [B, C*M, T/M] and the streaming
    state carries one cache per (batch, channel) signal.

    Modes
    -----
    - ``forward(x)`` / ``inverse(x)``: offline, centered padding — the exact
      behavior of the reference's exported (non-cached) artifact;
      ``roundtrip(x)`` is their composition as one kernel (K3).
    - ``init_state(batch)`` + ``forward_block(state, x)`` /
      ``inverse_block(state, x)``: streaming; concatenated block outputs
      equal the causal offline output (``forward_causal`` /
      ``inverse_causal``).

    Conv geometry at (atten=100, M=16): analysis 1->16ch k=513 s=16,
    synthesis 16->16ch k=33 s=1 (reference pqmf.py:310-333).

    Inputs may be NumPy arrays (copied to the device) or float32 tensors
    already on it; only ``precision="highest"`` (full f32) is available.
    """

    def __init__(self, attenuation: float, n_band: int,
                 precision: str = "highest", n_channels: int = 1,
                 device="cpu"):
        power = math.log2(n_band)
        if power != math.floor(power):
            raise ValueError(f"n_band must be a power of 2, got {n_band}")
        self.n_band = n_band
        self.attenuation = attenuation
        self.precision = fb.check_precision(precision)
        self.n_channels = int(n_channels)
        self.device = resolve_device(device)
        self.weights_version = 0
        self._install(fb.build_filterbank(attenuation, n_band))

    def _install(self, params, hkf=None, hki=None):
        if hkf is None or hki is None:
            hkf, hki = kernels_from_params(params, self.device)
        self.params = {k: _on(v, self.device) for k, v in params.items()}
        self.hkf = _on(hkf, self.device)
        self.hki = _on(hki, self.device)
        M = self.n_band
        Ka, Ks = self.hkf.shape[-1], self.hki.shape[-1]
        if (self.device.type == "cuda" and M > 1
                and not cc.supports(M, Ka, Ks)):
            raise ValueError(
                f"the CUDA kernels do not take banks of {Ka}/{Ks} taps at "
                f"n_band={M} (see kernels.cached_conv.supports)")
        self._update_delays()

    def set_weights(self, params, hkf=None, hki=None):
        """Install filterbank weights (restored from an artifact, carried
        over from ``pqmf_tpu`` with ``params_from_jax``, or fine-tuned) in
        place of the designed ones; the conv kernels derive from ``params``
        unless given. Recomputes the latency bookkeeping and bumps
        ``weights_version`` so caches keyed on it see the swap."""
        self._install(params, hkf, hki)
        self.weights_version += 1

    def _update_delays(self):
        """Latency bookkeeping (cached_conv's cumulative_delay analog), in
        full-rate samples:
        - stream_vs_centered_delay: how much later the streamed output is
          than the centered-offline output;
        - centered_delay: the centered round trip's own group delay (16 at
          M=16, as the reference artifact measures);
        - latency_samples: total streamed round-trip delay vs the input.
        """
        M = self.n_band
        Ka = self.hkf.shape[-1]
        Ks = self.hki.shape[-1]
        a_left, _ = centered_padding(Ka)
        s_left, _ = centered_padding(Ks)
        self.stream_vs_centered_delay = ((Ka - M - a_left)
                                         + M * (Ks - 1 - s_left))
        self.centered_delay = a_left - Ka // 2 + M
        self.latency_samples = (self.stream_vs_centered_delay
                                + self.centered_delay)

    # -- inputs and channel folding -----------------------------------------

    def as_tensor(self, x) -> torch.Tensor:
        """An input as a tensor on this PQMF's device: arrays are copied
        there; a tensor must already be there (no silent transfer)."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"input is on {x.device}, this PQMF on "
                                 f"{self.device}")
            return x
        return _on(x, self.device)

    def _fold(self, x):
        """[B, C, T] (or [C, T] / [T]) -> ([B*C, 1, T], B)."""
        x = self.as_tensor(x)
        if x.ndim == 1:
            x = x[None, None, :]
        elif x.ndim == 2:
            x = x[None]
        B, C, T = x.shape
        if C != self.n_channels:
            raise ValueError(
                f"expected {self.n_channels} channel(s), got {C}")
        return x.reshape(B * C, 1, T), B

    def _fold_bands(self, x):
        """[B, C*M, T'] (or [C*M, T']) -> ([B*C, M, T'], B)."""
        x = self.as_tensor(x)
        if x.ndim == 2:
            x = x[None]
        B, CM, Tp = x.shape
        if CM != self.n_channels * self.n_band:
            raise ValueError(
                f"expected {self.n_channels * self.n_band} rows "
                f"(C*M), got {CM}")
        return x.reshape(B * self.n_channels, self.n_band, Tp), B

    # -- offline (centered) ------------------------------------------------

    def forward(self, x):
        """[B, C, T] -> [B, C*M, T/M]."""
        xf, B = self._fold(x)
        if self.n_band == 1:
            return xf.reshape(B, self.n_channels, -1)
        _, y = _cached_analysis(xf, self.hkf, None, mode="offline")
        return y.reshape(B, self.n_channels * self.n_band, -1)

    def inverse(self, x):
        """[B, C*M, T'] -> [B, C, T'*M]."""
        xf, B = self._fold_bands(x)
        if self.n_band == 1:
            return xf.reshape(B, self.n_channels, -1)
        _, y = _cached_synthesis(xf, self.hki, None, mode="offline")
        return y.reshape(B, self.n_channels, -1)

    def roundtrip(self, x):
        """``inverse(forward(x))`` as one kernel, K3 ([B, C, T] ->
        [B, C, T]): the sub-bands never leave the card's shared memory and
        the two ``reverse_half`` masks cancel. Geometries K3 does not take
        (see ``fused_roundtrip_supported``) run as K1 then K2."""
        M = self.n_band
        Ka, Ks = self.hkf.shape[-1], self.hki.shape[-1]
        if M == 1 or not cc.fused_roundtrip_supported(M, Ka, Ks):
            return self.inverse(self.forward(x))
        xf, B = self._fold(x)
        xx = F.pad(xf, centered_padding(Ka))
        out = cc.fused_roundtrip_conv(xx, self.hkf, self.hki, M,
                                      centered_padding(Ks))
        return out.reshape(B, self.n_channels, -1)

    # -- streaming ----------------------------------------------------------

    def init_state(self, batch: int = 1) -> dict:
        M = self.n_band
        rows = batch * self.n_channels  # one cache per (batch, channel)
        return {
            "analysis": conv_state_init(rows, 1, self.hkf.shape[-1], M,
                                        self.device),
            "synthesis": conv_state_init(rows, M, self.hki.shape[-1], 1,
                                         self.device),
        }

    def _check_block_parity(self, sub_len: int, what: str):
        """``reverse_half``'s sign is block-local, so a block with an odd
        sub-band length would SILENTLY diverge from the offline output from
        the next block on — reject it loudly."""
        if self.n_band >= 2 and sub_len % 2:
            raise ValueError(
                f"streaming {what} block has odd sub-band length "
                f"{sub_len}; blocks must be a multiple of 2*n_band="
                f"{2 * self.n_band} full-rate samples (reverse_half's "
                f"block-local sign parity would silently corrupt every "
                f"later block)")

    def forward_block(self, state: dict, x):
        xf, B = self._fold(x)
        T = xf.shape[-1]
        if T % self.n_band:
            raise ValueError(
                f"block length {T} must be a multiple of "
                f"n_band={self.n_band}")
        self._check_block_parity(T // self.n_band, "analysis")
        new, y = _cached_analysis(xf, self.hkf, state["analysis"],
                                  mode="streaming")
        return ({**state, "analysis": new},
                y.reshape(B, self.n_channels * self.n_band, -1))

    def inverse_block(self, state: dict, x):
        xf, B = self._fold_bands(x)
        self._check_block_parity(xf.shape[-1], "synthesis")
        new, y = _cached_synthesis(xf, self.hki, state["synthesis"],
                                   mode="streaming")
        return ({**state, "synthesis": new},
                y.reshape(B, self.n_channels, -1))

    def process_block(self, state: dict, x):
        """Analysis + synthesis round-trip of one block."""
        state, bands = self.forward_block(state, x)
        return self.inverse_block(state, bands)

    # -- causal offline (ground truth for the streaming property) -----------

    def forward_causal(self, x):
        xf, B = self._fold(x)
        _, y = _cached_analysis(xf, self.hkf, None, mode="causal")
        return y.reshape(B, self.n_channels * self.n_band, -1)

    def inverse_causal(self, x):
        xf, B = self._fold_bands(x)
        _, y = _cached_synthesis(xf, self.hki, None, mode="causal")
        return y.reshape(B, self.n_channels, -1)
