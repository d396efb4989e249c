"""L1 — the offline PQMF module: analysis/synthesis over a QMF bank.

PyTorch counterpart of ``pqmf_tpu/filterbank.py``'s :class:`PQMF` (the
reference ``PQMF`` nn.Module, pqmf.py:202-288). Channels fold into the
batch of a mono core. The polyphase path runs the adapters of
:mod:`pqmf_tpu_torch.kernels.polyphase`: on a CUDA device K4 (over K1) for
``forward``, K5 (over K2) for ``inverse`` and K6 (over K3) for
``roundtrip``; on the CPU the same wrappers run their plain versions. The
classic path (``polyphase=False``) is plain tensor code on every device, as
in the JAX package, whose classic path reaches no Pallas kernel.

Under a (data, band) mesh (``mesh=``) each rank keeps its row shard of
``hk_poly`` and its column shard of ``hk_ipoly``: K4 and K5 run on its band
shard (``streaming.shard_band_analysis`` / ``shard_band_synthesis``, K5's
partial outputs summed over the band group), and ``roundtrip`` is K4 then
K5, without K6, as in the JAX package (``pqmf_tpu/filterbank.py:244``).
"""

from __future__ import annotations

import math
import warnings

from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.streaming import (BandLayout, _on, as_device_tensor,
                                      resolve_device, shard_band_analysis,
                                      shard_band_synthesis)
from pqmf_tpu_torch.utils.profiling import span

__all__ = ["PQMF"]


class PQMF:
    """Pseudo-QMF analysis/synthesis filterbank, on one device or over a
    mesh.

    Parameters
    ----------
    attenuation : float
        Stopband attenuation in dB (80-120).
    n_band : int
        Number of sub-bands; must be a power of two when ``polyphase``.
    polyphase : bool
        The fast polyphase path (default, on the kernels) or the classic
        full-rate one (plain).
    n_channels : int
        Channels per signal; they fold into the batch of the mono core.
    precision : str
        The conv tier, as in the JAX package: ``"highest"`` (full f32, K4-K6
        over K1-K3), ``"bf16x3"`` or ``"default"`` (K4-K6 over the
        tensor-core K1t-K3t; the classic path's plain convs at the tier).
    device : str or torch.device
        ``"cuda"`` (the default; raises without a card) or ``"cpu"``;
        inputs may be NumPy arrays (copied to the device) or float32
        tensors already on it.
    mesh : DeviceMesh or None
        A (data, band) mesh (``parallel.sharding.make_mesh``) whose band
        axis splits ``n_band`` into even shards (else ``ValueError``): K4
        and K5 run band-partitioned, inputs are global tensors or
        ``DTensor`` s and outputs ``DTensor`` s over the mesh (as
        ``StreamingPQMF``'s). The classic path runs unsharded and warns,
        as the JAX package's.
    """

    def __init__(self, attenuation: float, n_band: int, polyphase: bool = True,
                 n_channels: int = 1, precision: str = "highest",
                 device="cuda", mesh=None):
        if polyphase:
            power = math.log2(n_band)
            if power != math.floor(power):
                raise ValueError(
                    "n_band must be a power of 2 for the polyphase "
                    f"algorithm, got {n_band}")
        self.n_band = n_band
        self.attenuation = attenuation
        self.polyphase = polyphase
        self.n_channels = n_channels
        self.precision = fb.check_precision(precision)
        self.device = resolve_device(device)
        checked = pk.check_band_mesh(mesh, n_band)
        if mesh is not None and not polyphase:
            warnings.warn(
                "mesh provided but the band-partitioned path is the "
                "polyphase one (polyphase=False); convs run unsharded",
                stacklevel=2)
            checked = None
        self.mesh = checked
        self._layout = None if checked is None else BandLayout(checked,
                                                                n_band)
        self.set_weights(fb.build_filterbank(attenuation, n_band))

    def set_weights(self, params):
        """Install filterbank weights (an artifact's, a fine-tuned bank
        from ``parallel.training.load_pretrained_bank``, or a ``pqmf_tpu``
        bank through ``params_from_jax``) in place of the designed ones.
        Builds the kernels' layout of the bank here, once (K1's ``w2``, and
        at a tier K1t's and K2t's arranged banks)."""
        params = {k: _on(v, self.device) for k, v in params.items()}
        M = self.n_band
        L = params["hk_poly"].shape[-1]
        if self.polyphase and L == 0:
            raise ValueError(
                "restored bank length is not divisible by n_band — it has "
                "no polyphase form; rebuild with polyphase=False")
        if (self.polyphase and self.device.type == "cuda" and M > 1
                and not pk.supports(M, L, self.precision)):
            raise ValueError(
                f"the CUDA kernels do not take polyphase banks of {L} taps "
                f"per phase at n_band={M} (see kernels.polyphase.supports)")
        self.params = params
        # this rank's row shard of hk_poly and column shard of hk_ipoly
        # (the whole banks without a mesh), cut here once
        sl = slice(None) if self._layout is None else self._layout.bands
        self._hp = params["hk_poly"][sl].contiguous()
        self._hi = params["hk_ipoly"][:, sl].contiguous()
        self._w2 = pk.analysis_weights(self._hp) if L else None
        # K1t/K2t's banks of the shards at a tier, arranged here once
        self.tc_banks = {"analysis": None, "synthesis": None}
        if self.polyphase and L and M > 1 and self.precision != "highest":
            self.tc_banks = {
                "analysis": cc.arrange_tc_bank(self._w2, "analysis",
                                               self.precision),
                "synthesis": cc.arrange_tc_bank(self._hi, "synthesis",
                                                self.precision)}
        # aliases mirroring the reference's buffers
        self.h = params["h"]
        self.hk = params["hk"]

    # -- shape normalization ------------------------------------------------

    def _to_bct(self, x):
        x = as_device_tensor(x, self.device)
        if x.ndim == 1:
            x = x[None, None, :]
        elif x.ndim == 2:
            x = x[None]  # [C, T] -> [1, C, T]
        if x.ndim != 3:
            raise ValueError(
                f"expected rank <= 3 input, got shape {tuple(x.shape)}")
        if x.shape[1] != self.n_channels:
            raise ValueError(
                f"expected {self.n_channels} channel(s), got {x.shape[1]} "
                f"(shape {tuple(x.shape)}); construct PQMF(..., "
                f"n_channels={x.shape[1]}) for this input")
        return x

    def _fold(self, x):
        """[B, C, T] -> ([B*C, 1, T] of this rank's rows, B, T), checking
        T % n_band."""
        B, C, T = x.shape
        if T % self.n_band:
            raise ValueError(
                f"T={T} must be divisible by n_band={self.n_band}")
        if self._layout is not None:
            x = self._layout.local(x, data_dim=0)
        return x.reshape(-1, 1, T), B, T

    # -- public API ----------------------------------------------------------

    def forward(self, x):
        """Decompose into sub-bands: [B, C, T] -> [B, C*M, T/M] (also
        accepts [C, T] or [T])."""
        x = self._to_bct(x)
        if self.n_band == 1:
            return x
        xc, B, T = self._fold(x)
        lay = self._layout
        if self.polyphase:
            def k4(v, hp):
                return pk.polyphase_analysis(
                    v, hp, self._w2, mxu_precision=self.precision,
                    tc_bank=self.tc_banks["analysis"])

            y = (k4(xc, self._hp) if lay is None
                 else shard_band_analysis(self.mesh, k4, xc, self._hp))
        else:
            y = fb.reverse_half(fb.classic_forward(xc, self.params["hk"],
                                                   self.precision))
        if lay is None:
            return y.reshape(B, self.n_channels * self.n_band,
                             T // self.n_band)
        return lay.wrap_bands(y, B, self.n_channels)

    def inverse(self, x):
        """Reconstruct from sub-bands: [B, C*M, T'] -> [B, C, T'*M] (also
        accepts [C*M, T'])."""
        x = as_device_tensor(x, self.device)
        if x.ndim == 2:
            x = x[None]
        if self.n_band == 1:
            return x
        B, CM, Tp = x.shape
        if CM != self.n_channels * self.n_band:
            raise ValueError(
                f"expected {self.n_channels * self.n_band} rows "
                f"({self.n_channels} channel(s) x {self.n_band} bands), "
                f"got {CM}")
        lay, C, M = self._layout, self.n_channels, self.n_band
        xc = (x.reshape(B * C, M, Tp) if lay is None
              else lay.local_bands(x, C))
        if self.polyphase:
            def k5(v, hi):
                return pk.polyphase_synthesis(
                    v, hi, mxu_precision=self.precision,
                    tc_bank=self.tc_banks["synthesis"])

            y = (k5(xc, self._hi) if lay is None
                 else shard_band_synthesis(self.mesh, k5, xc, self._hi))
        else:
            y = fb.classic_inverse(fb.reverse_half(xc), self.params["hk"],
                                   self.precision)
        if lay is None:
            return y.reshape(B, C, Tp * M)
        return lay.wrap_signal(y, B, C)

    def roundtrip(self, x):
        """``inverse(forward(x))`` ([B, C, T] -> [B, C, T]): one K6 launch
        where K3 takes the geometry (``roundtrip_supported``: every
        committed bank, M = 2 to 64; K3t at a tier, reading the kept
        arranged banks), else K4 then K5 — and K4 then K5 under a mesh."""
        with span("pqmf.entry.roundtrip"):
            x = self._to_bct(x)
            if self.n_band == 1:
                return x
            M = self.n_band
            hk_poly = self.params["hk_poly"]
            hk_ipoly = self.params["hk_ipoly"]
            if not (self.polyphase and self._layout is None
                    and pk.roundtrip_supported(
                    M, hk_poly.shape[-1] * M, hk_ipoly.shape[-1],
                    self.precision)):
                return self.inverse(self.forward(x))
            xc, B, T = self._fold(x)
            banks = None if self.precision == "highest" else (
                self.tc_banks["analysis"], self.tc_banks["synthesis"])
            y = pk.polyphase_roundtrip(xc, hk_poly, hk_ipoly, self._w2,
                                       self.precision, banks)
            return y.reshape(B, self.n_channels, T)

    __call__ = forward
