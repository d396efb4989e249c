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
runs K1, the synthesis K2 and :meth:`StreamingPQMF.roundtrip` K3 (K1t,
K2t and K3t at the ``"bf16x3"`` and ``"default"`` tiers); on the CPU the
same wrappers run their plain versions at the same tier.

Under a (data, band) mesh (``mesh=``, a 2-D ``DeviceMesh`` from
``parallel.sharding.make_mesh``; one process a device, SPMD over
``torch.distributed``) each rank keeps its row shard of the analysis bank
and its column shard of the synthesis bank, runs K1/K2 (K1t/K2t) on its
band shard and sums the partial synthesis outputs over the band group with
one ``all_reduce`` (:func:`shard_band_analysis`,
:func:`shard_band_synthesis`, the JAX package's ``shard_map`` regions).
Inputs are the global value (the same tensor on every rank) or a
``DTensor``; outputs are ``DTensor`` s over the mesh whose
``full_tensor()`` is the JAX package's global array (:class:`BandLayout`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from pqmf_tpu_torch import graphs
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.utils.profiling import span

__all__ = [
    "centered_padding",
    "streaming_conv",
    "offline_conv",
    "conv_state_init",
    "kernels_from_params",
    "resolve_device",
    "as_device_tensor",
    "scan_blocks",
    "shard_band_analysis",
    "shard_band_synthesis",
    "BandLayout",
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


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """An input as a tensor on ``device``: arrays are copied there (the
    ``pqmf.handover`` span); a tensor must already be there (no silent
    transfer)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"input is on {x.device}, this PQMF on "
                             f"{device}")
        return x
    with span("pqmf.handover"):
        return _on(x, device)


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


def _state_dtype(dtype) -> torch.dtype:
    """The streaming state's dtype: float32 only, the one K1/K2 read (as
    ``torch.float32`` or any NumPy-style spelling of it, such as the
    reference's ``jnp.float32``); any other raises ``ValueError``."""
    if dtype is torch.float32:
        return dtype
    try:
        ok = np.dtype(dtype) == np.float32
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(f"the streaming state is float32 (the kernels take "
                         f"f32 operands only), got dtype={dtype!r}")
    return torch.float32


def conv_state_init(batch: int, in_ch: int, kernel: int, stride: int,
                    device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Zero cache of the ``kernel - stride`` past input samples, float32
    (``dtype`` as the reference takes it; anything else raises)."""
    return torch.zeros((batch, in_ch, kernel - stride),
                       dtype=_state_dtype(dtype), device=device)


def streaming_conv(state, x, w, stride: int = 1,
                   precision: str = "highest"):
    """One streaming step of a cached Conv1d (plain, at ``precision``).

    state: [B, Cin, K-S] carried past samples; x: [B, Cin, T] (T % S == 0);
    w: [Cout, Cin, K]. Returns (state', y [B, Cout, T/S])."""
    K = w.shape[-1]
    xx = torch.cat([state, x], dim=-1)
    y = fb._conv1d(xx, w, stride=stride, precision=precision)
    return xx[..., xx.shape[-1] - (K - stride):], y


def offline_conv(x, w, stride: int = 1, causal: bool = False,
                 precision: str = "highest"):
    """Offline reference for the streaming property: centered (the
    reference's exported non-cached mode) or causal (what streaming
    reproduces from zero initial state)."""
    K = w.shape[-1]
    pad = (K - stride, 0) if causal else centered_padding(K)
    return fb._conv1d(x, w, stride=stride, padding=pad, precision=precision)


# ---------------------------------------------------------------------------
# the (data, band) mesh
# ---------------------------------------------------------------------------


class BandLayout:
    """This rank's part of the tensors of a (data, band) mesh.

    A batch axis is split over ``data`` when the global batch divides by
    it, else replicated (as the JAX package's ``shard_band_*`` choose, its
    ``streaming.py:143``); a band axis is split over ``band`` into even
    shards of ``Mb = n_band / band`` bands when ``split_bands`` (else every
    rank keeps every band, as ``ShardedPitchShift`` does on a mesh whose
    band shards would be odd). ``local`` takes this rank's part of a global
    tensor (the same on every rank) or of a ``DTensor`` (redistributed only
    where its placements differ), ``wrap`` makes a rank's part into the
    ``DTensor`` of the global value. ``group`` is the band group of the
    synthesis ``all_reduce`` (None without a band split)."""

    def __init__(self, mesh, n_band: int, split_bands: bool = True):
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.mesh = mesh
        self.data, self.band = mesh.size(0), mesh.size(1)
        self.data_rank, self.band_rank = coord
        self.split_bands = split_bands
        if split_bands:
            self.Mb = n_band // self.band
            self.bands = slice(self.band_rank * self.Mb,
                               (self.band_rank + 1) * self.Mb)
            self.group = mesh.get_group(1)
        else:
            self.Mb, self.bands, self.group = n_band, slice(None), None

    def _placements(self, data_dim, band_dim, batch):
        from torch.distributed.tensor import Replicate, Shard

        split = data_dim is not None and batch % self.data == 0
        return [Shard(data_dim) if split else Replicate(),
                Shard(band_dim) if band_dim is not None and self.split_bands
                else Replicate()]

    def local(self, x, data_dim=None, band_dim=None, batch=None):
        """This rank's part of ``x``: its rows of ``data_dim`` (when
        ``batch``, by default that axis's global size, divides by the data
        axis) and its band shard of ``band_dim``."""
        from torch.distributed.tensor import DTensor

        if batch is None and data_dim is not None:
            batch = x.shape[data_dim]
        want = self._placements(data_dim, band_dim, batch)
        if isinstance(x, DTensor):
            if x.device_mesh != self.mesh:
                raise ValueError("the DTensor lies on another mesh")
            if list(x.placements) != want:
                x = x.redistribute(self.mesh, want)
            return x.to_local()
        for dim, p, rank, size in (
                (data_dim, want[0], self.data_rank, self.data),
                (band_dim, want[1], self.band_rank, self.band)):
            if p.is_shard():
                n = x.shape[dim] // size
                x = x.narrow(dim, rank * n, n)
        return x

    def wrap(self, t, data_dim=None, band_dim=None, batch=None):
        """The ``DTensor`` whose local part on this rank is ``t``; ``batch``
        is the global size of ``data_dim``."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            t, self.mesh, self._placements(data_dim, band_dim, batch),
            run_check=False)

    def local_bands(self, x, C: int):
        """This rank's rows and bands of global sub-bands [B, C*M, T'] (a
        tensor or DTensor) -> [B*C, Mb, T'] (rows of the data shard)."""
        if C == 1:
            return self.local(x, data_dim=0, band_dim=1)
        x = self.local(x, data_dim=0)
        x = x.reshape(x.shape[0], C, -1, x.shape[-1])[:, :, self.bands]
        return x.reshape(-1, self.Mb, x.shape[-1])

    def wrap_bands(self, y, B: int, C: int):
        """This rank's sub-bands [B*C, Mb, T'] -> the DTensor [B, C*M, T']:
        band-split for one channel; for more, whose bands interleave with
        the channels, gathered over the band axis."""
        if C == 1:
            return self.wrap(y, data_dim=0, band_dim=1, batch=B)
        from torch.distributed.tensor import Replicate

        Tp = y.shape[-1]
        d = self.wrap(y.reshape(-1, C, self.Mb, Tp), data_dim=0, band_dim=2,
                      batch=B)
        full = d.redistribute(self.mesh, [d.placements[0], Replicate()])
        return self.wrap(full.to_local().reshape(-1, C * self.band * self.Mb,
                                                 Tp), data_dim=0, batch=B)

    def wrap_signal(self, y, B: int, C: int):
        """This rank's rows [B*C, 1, T] -> the DTensor [B, C, T]."""
        return self.wrap(y.reshape(-1, C, y.shape[-1]), data_dim=0, batch=B)


def shard_band_analysis(mesh, conv, x, w):
    """Band-partitioned analysis: this rank runs ``conv(x, w)`` with its
    ROW shard of the bank (``w`` [Mb, ...], sharded on axis 0) over its
    rows of the band-replicated signal, and gets its [B, Mb, T'] sub-band
    shard; no collective. The sharding contract of the streaming and
    offline paths lives here and in :func:`shard_band_synthesis` (the JAX
    package's ``shard_band_analysis``, ``pqmf_tpu/streaming.py:133``)."""
    return conv(x, w)


def band_all_reduce(y, group):
    """Sum ``y`` over the band group in place: the one collective of a
    round trip. Counted in ``graphs.COLLECTIVES["band_all_reduce"]``."""
    import torch.distributed as dist

    dist.all_reduce(y, group=group)
    graphs.COLLECTIVES["band_all_reduce"] += 1
    return y


def shard_band_synthesis(mesh, conv, x, w):
    """Band-partitioned synthesis: this rank contracts its band shard (the
    signal's axis 1 and the bank's COLUMN shard, ``w`` [M, Mb, ...]) with
    ``conv(x, w)``, and the partial outputs are summed over the band group
    by one ``all_reduce`` (the JAX package's ``psum``,
    ``pqmf_tpu/streaming.py:151``)."""
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"synthesis shard: {x.shape[1]} bands against a "
                         f"bank of {w.shape[1]}")
    return band_all_reduce(conv(x, w), mesh.get_group(1))


def _cached_analysis(x, hkf, state, mode="offline", precision="highest",
                     bank=None, mesh=None):
    """CachedPQMF.forward (pqmf.py:339-343): strided 1->M conv and sign
    mask, as K1 (K1t at a tier, reading the arranged ``bank``) over the
    mode's padded input (K1 applies the offline and causal zero pads
    itself). Returns (state', y). Under a ``mesh`` x and state are this
    rank's rows and ``hkf`` its row shard of the bank
    (:func:`shard_band_analysis`)."""
    K = hkf.shape[-1]
    M = hkf.shape[0] * (1 if mesh is None else mesh.size(1))
    if mode == "offline":
        pad, xx, new_state = centered_padding(K), x.contiguous(), state
    elif mode == "causal":
        pad, xx, new_state = (K - M, 0), x.contiguous(), state
    else:  # streaming
        xx = torch.cat([state, x], dim=-1)
        pad, new_state = (0, 0), xx[..., xx.shape[-1] - (K - M):]

    def conv(v, w):
        return cc.strided_analysis_conv(v, w, M, pad=pad,
                                        mxu_precision=precision, bank=bank)

    if mesh is not None:
        return new_state, shard_band_analysis(mesh, conv, xx, hkf)
    return new_state, conv(xx, hkf)


def _cached_synthesis(x, hki, state, mode="offline", precision="highest",
                      bank=None, mesh=None):
    """CachedPQMF.inverse (pqmf.py:345-354): sign mask, M->M conv * M, band
    flip, phase interleave, as K2 (K2t at a tier, reading the arranged
    ``bank``) over the mode's padded input (K2 applies the offline and
    causal zero pads itself). Returns (state', y [B, 1, T'*M]). Under a
    ``mesh`` x and state are this rank's rows and band shard, ``hki`` its
    column shard of the bank, and y the sum over the band group
    (:func:`shard_band_synthesis`)."""
    K = hki.shape[-1]
    if mode in ("offline", "causal"):
        pad = centered_padding(K) if mode == "offline" else (K - 1, 0)
        xx, fuse, new_state = x.contiguous(), True, state
    else:
        # block-local sign mask first: the carried tail keeps the previous
        # block's masked samples
        xx = torch.cat([state, fb.reverse_half(x)], dim=-1)
        pad, fuse, new_state = (0, 0), False, xx[..., xx.shape[-1] - (K - 1):]

    def conv(v, w):
        return cc.dense_synthesis_conv(v, w, fuse_mask=fuse, x_offset=0,
                                       mxu_precision=precision, pad=pad,
                                       bank=bank)

    y = (conv(xx, hki) if mesh is None
         else shard_band_synthesis(mesh, conv, xx, hki))
    return new_state, y.reshape(y.shape[0], 1, -1)


class StreamingPQMF:
    """Streaming PQMF with explicit state, on one device or over a mesh.

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

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; without
    a card ``"cuda"`` raises. Inputs may be NumPy arrays (copied to the
    device) or float32 tensors already on it. ``precision`` is the JAX
    package's tier of every conv: ``"highest"`` (full f32, K1/K2/K3),
    ``"bf16x3"`` or ``"default"`` (split-bf16 on the tensor cores,
    K1t/K2t/K3t).

    ``mesh``: a (data, band) ``DeviceMesh`` (``parallel.sharding.
    make_mesh``) whose band axis splits ``n_band`` into even shards
    (``kernels.polyphase.check_band_mesh``; anything else raises
    ``ValueError``). Every rank then keeps its shard of both banks
    (``hkf_shard``, ``hki_shard``, their arranged banks in ``tc_banks``),
    runs K1/K2 on it, and the synthesis sums over the band group; inputs
    are global tensors or ``DTensor`` s, outputs ``DTensor`` s (the module
    docstring), the streaming state too: its analysis cache is split over
    data, its synthesis cache over data and band. ``roundtrip`` is then
    ``inverse(forward(x))``: no K3, as in the JAX package.
    """

    def __init__(self, attenuation: float, n_band: int,
                 precision: str = "highest", mesh=None, n_channels: int = 1,
                 device="cuda"):
        power = math.log2(n_band)
        if power != math.floor(power):
            raise ValueError(f"n_band must be a power of 2, got {n_band}")
        self.n_band = n_band
        self.attenuation = attenuation
        self.precision = fb.check_precision(precision)
        self.n_channels = int(n_channels)
        self.device = resolve_device(device)
        self.mesh = self._check_mesh(mesh)
        self._layout = (None if self.mesh is None
                        else BandLayout(self.mesh, n_band))
        self.weights_version = 0
        self._graphs = {}  # scan_blocks' CUDA graphs (graphs.call)
        self._install(fb.build_filterbank(attenuation, n_band))

    def _check_mesh(self, mesh):
        """Validate a (data, band) mesh for the band-partitioned kernels
        (``kernels.polyphase.check_band_mesh``)."""
        from pqmf_tpu_torch.kernels.polyphase import check_band_mesh

        return check_band_mesh(mesh, self.n_band)

    @property
    def band_slice(self) -> slice:
        """This rank's bands: ``slice(None)`` without a mesh."""
        return slice(None) if self._layout is None else self._layout.bands

    def _install(self, params, hkf=None, hki=None):
        if hkf is None or hki is None:
            hkf, hki = kernels_from_params(params, self.device)
        hkf, hki = _on(hkf, self.device), _on(hki, self.device)
        M = self.n_band
        Ka, Ks = hkf.shape[-1], hki.shape[-1]
        if (self.device.type == "cuda" and M > 1
                and not cc.supports(M, Ka, Ks, self.precision)):
            raise ValueError(
                f"the CUDA kernels do not take banks of {Ka}/{Ks} taps at "
                f"n_band={M} (see kernels.cached_conv.supports)")
        self.params = {k: _on(v, self.device) for k, v in params.items()}
        self.hkf, self.hki = hkf, hki
        # this rank's row shard of the analysis bank and column shard of
        # the synthesis bank, cut here once (the whole banks without a mesh)
        sl = self.band_slice
        self.hkf_shard = hkf[sl].contiguous()
        self.hki_shard = hki[:, sl].contiguous()
        # K1t/K2t's banks of the shards, arranged here once (none at
        # "highest")
        self.tc_banks = {"analysis": None, "synthesis": None}
        if self.precision != "highest" and M > 1:
            self.tc_banks = {
                "analysis": cc.arrange_tc_bank(self.hkf_shard, "analysis",
                                               self.precision),
                "synthesis": cc.arrange_tc_bank(self.hki_shard, "synthesis",
                                                self.precision)}
        self._update_delays()

    def set_weights(self, params, hkf=None, hki=None):
        """Install filterbank weights (restored from an artifact, carried
        over from ``pqmf_tpu`` with ``params_from_jax``, or fine-tuned) in
        place of the designed ones; the conv kernels derive from ``params``
        unless given, and the rank's shards and K1t/K2t's arranged banks are
        built again. Recomputes the latency bookkeeping and bumps
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
        """An input as a tensor on this PQMF's device (as_device_tensor)."""
        return as_device_tensor(x, self.device)

    def _fold(self, x):
        """[B, C, T] (or [C, T] / [T]) -> ([B*C, 1, T] of this rank's rows,
        global B)."""
        x = self.as_tensor(x)
        if x.ndim == 1:
            x = x[None, None, :]
        elif x.ndim == 2:
            x = x[None]
        B, C, T = x.shape
        if C != self.n_channels:
            raise ValueError(
                f"expected {self.n_channels} channel(s), got {C}")
        if self._layout is not None:
            x = self._layout.local(x, data_dim=0)
        return x.reshape(-1, 1, T), B

    def _fold_bands(self, x):
        """[B, C*M, T'] (or [C*M, T']) -> ([B*C, Mb, T'] of this rank's rows
        and bands, global B)."""
        x = self.as_tensor(x)
        if x.ndim == 2:
            x = x[None]
        B, CM, Tp = x.shape
        C, M = self.n_channels, self.n_band
        if CM != C * M:
            raise ValueError(
                f"expected {C * M} rows (C*M), got {CM}")
        if self._layout is None:
            return x.reshape(B * C, M, Tp), B
        return self._layout.local_bands(x, C), B

    def _bands_out(self, y, B):
        """This rank's sub-bands [B*C, Mb, T'] -> [B, C*M, T'] (a DTensor
        under a mesh)."""
        if self._layout is None:
            return y.reshape(B, self.n_channels * self.n_band, y.shape[-1])
        return self._layout.wrap_bands(y, B, self.n_channels)

    def _signal_out(self, y, B):
        """This rank's rows [B*C, 1, T] -> [B, C, T] (a DTensor under a
        mesh, band-replicated)."""
        if self._layout is None:
            return y.reshape(-1, self.n_channels, y.shape[-1])
        return self._layout.wrap_signal(y, B, self.n_channels)

    def _state_out(self, t, B, banded: bool):
        if self._layout is None:
            return t
        return self._layout.wrap(t, data_dim=0, batch=B,
                                 band_dim=1 if banded else None)

    # -- this rank's part: the bodies of the entries and of the wrappers ----

    def _forward_local(self, xf):
        """Offline analysis of this rank's rows [R, 1, T] -> its sub-band
        shard [R, Mb, T/M] (a passthrough at n_band == 1)."""
        if self.n_band == 1:
            return xf
        return _cached_analysis(xf, self.hkf_shard, None, mode="offline",
                                precision=self.precision,
                                bank=self.tc_banks["analysis"],
                                mesh=self.mesh)[1]

    def _inverse_local(self, xf):
        """Offline synthesis of this rank's sub-band shard [R, Mb, T'] ->
        [R, 1, T'*M], summed over the band group under a mesh."""
        if self.n_band == 1:
            return xf
        return _cached_synthesis(xf, self.hki_shard, None, mode="offline",
                                 precision=self.precision,
                                 bank=self.tc_banks["synthesis"],
                                 mesh=self.mesh)[1]

    def _roundtrip_local(self, xf):
        """The round trip of this rank's rows [R, 1, T] -> [R, 1, T]: one K3
        (K3t) where it takes the geometry and there is no mesh, else K1
        then K2 (and the band sum)."""
        M = self.n_band
        Ka, Ks = self.hkf.shape[-1], self.hki.shape[-1]
        if (M == 1 or self.mesh is not None
                or not cc.fused_roundtrip_supported(M, Ka, Ks,
                                                    self.precision)):
            return self._inverse_local(self._forward_local(xf))
        banks = None if self.precision == "highest" else (
            self.tc_banks["analysis"], self.tc_banks["synthesis"])
        out = cc.fused_roundtrip_conv(xf.contiguous(), self.hkf, self.hki, M,
                                      centered_padding(Ks), self.precision,
                                      pad=centered_padding(Ka), banks=banks)
        return out.reshape(out.shape[0], 1, -1)

    # -- offline (centered) ------------------------------------------------

    def forward(self, x):
        """[B, C, T] -> [B, C*M, T/M]."""
        xf, B = self._fold(x)
        if self.n_band == 1:
            return self._signal_out(xf, B)
        return self._bands_out(self._forward_local(xf), B)

    def inverse(self, x):
        """[B, C*M, T'] -> [B, C, T'*M]."""
        xf, B = self._fold_bands(x)
        return self._signal_out(self._inverse_local(xf), B)

    def roundtrip(self, x):
        """``inverse(forward(x))`` as one kernel, K3 ([B, C, T] ->
        [B, C, T]): the sub-bands never leave the card's shared memory and
        the two ``reverse_half`` masks cancel (K3t at a tier, reading the
        kept arranged banks). K3 applies the centered pad itself. Every
        committed bank, M = 2 to 64, designed or fine-tuned, takes one K3
        launch; a geometry K3 does not take (see
        ``fused_roundtrip_supported``) runs as K1 then K2, and so does
        every round trip under a mesh (K1 and K2 on the band shard, then
        the band sum: the JAX package's ``streaming.py:447``)."""
        if self._layout is not None:
            return self.inverse(self.forward(x))
        xf, B = self._fold(x)
        return self._signal_out(self._roundtrip_local(xf), B)

    # -- streaming ----------------------------------------------------------

    def init_state(self, batch: int = 1, dtype=torch.float32) -> dict:
        """Zero streaming state for ``batch`` signals, float32 (``dtype``
        as the reference takes it; anything else raises ``ValueError``).
        Under a mesh, ``DTensor`` s: the analysis cache [B*C, 1, K-M] split
        over data, the synthesis cache [B*C, M, K-1] over data and band."""
        M = self.n_band
        rows = batch * self.n_channels  # one cache per (batch, channel)
        lay = self._layout
        if lay is not None:
            rows = rows // lay.data if batch % lay.data == 0 else rows
        ana = conv_state_init(rows, 1, self.hkf.shape[-1], M, self.device,
                              dtype)
        syn = conv_state_init(rows, M if lay is None else lay.Mb,
                              self.hki.shape[-1], 1, self.device, dtype)
        return {"analysis": self._state_out(ana, batch, banded=False),
                "synthesis": self._state_out(syn, batch, banded=True)}

    def _state_in(self, t, B, banded: bool):
        """This rank's part of a streaming cache (global or DTensor)."""
        if self._layout is None:
            return t
        return self._layout.local(t, data_dim=0, batch=B,
                                  band_dim=1 if banded else None)

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
        new, y = _cached_analysis(xf, self.hkf_shard,
                                  self._state_in(state["analysis"], B, False),
                                  mode="streaming", precision=self.precision,
                                  bank=self.tc_banks["analysis"],
                                  mesh=self.mesh)
        return ({**state, "analysis": self._state_out(new, B, False)},
                self._bands_out(y, B))

    def inverse_block(self, state: dict, x):
        xf, B = self._fold_bands(x)
        self._check_block_parity(xf.shape[-1], "synthesis")
        new, y = _cached_synthesis(xf, self.hki_shard,
                                   self._state_in(state["synthesis"], B,
                                                  True),
                                   mode="streaming",
                                   precision=self.precision,
                                   bank=self.tc_banks["synthesis"],
                                   mesh=self.mesh)
        return ({**state, "synthesis": self._state_out(new, B, True)},
                self._signal_out(y, B))

    def process_block(self, state: dict, x):
        """Analysis + synthesis round-trip of one block."""
        state, bands = self.forward_block(state, x)
        return self.inverse_block(state, bands)

    # -- causal offline (ground truth for the streaming property) -----------

    def forward_causal(self, x):
        xf, B = self._fold(x)
        _, y = _cached_analysis(xf, self.hkf_shard, None, mode="causal",
                                precision=self.precision,
                                bank=self.tc_banks["analysis"],
                                mesh=self.mesh)
        return self._bands_out(y, B)

    def inverse_causal(self, x):
        xf, B = self._fold_bands(x)
        _, y = _cached_synthesis(xf, self.hki_shard, None, mode="causal",
                                 precision=self.precision,
                                 bank=self.tc_banks["synthesis"],
                                 mesh=self.mesh)
        return self._signal_out(y, B)


def _versioned_owner(step_fn):
    """The object whose banks a bound ``step_fn`` reads, and their
    version: a ``StreamingPQMF`` (``process_block``) or a wrapper with one
    (``pitchshift_fn``, ``pitchshift_streams``); ``(None, None)`` for any
    other callable."""
    owner = getattr(step_fn, "__self__", None)
    if owner is None or not hasattr(owner, "_graphs"):
        return None, None
    version = getattr(owner, "weights_version", None)
    if version is None:
        version = getattr(getattr(owner, "pqmf", None), "weights_version",
                          None)
    return (owner, version) if version is not None else (None, None)


def _scan(step_fn, state, blocks):
    ys = []
    for block in blocks:
        state, y = step_fn(state, block)
        ys.append(y)
    return state, torch.stack(ys)


def scan_blocks(step_fn, state, blocks):
    """Run a streaming step over pre-framed blocks ``[n_blocks, B, C,
    T_block]`` (an array or a tensor): ``state, y = step_fn(state,
    blocks[i])`` in order, the state carried. Returns ``(state, ys)`` with
    the steps' outputs (tensors) stacked on a new first axis — the contract
    of the reference's ``scan_blocks`` (``lax.scan``, one program with no
    host round trip).

    On a CUDA device, when ``step_fn`` is a bound method of a
    ``StreamingPQMF`` (``process_block``) or of a wrapper over one
    (``pitchshift_fn``, ``pitchshift_streams``), the whole loop and the
    stack are one CUDA graph (``graphs.call``), cached on that object per
    (step, n_blocks, block shape, dtype, the state's tree and shapes,
    device, ``weights_version``): the first call of a stream's geometry
    runs the loop and captures it, later calls replay it; a graphed step
    runs its eager body inside that capture. The blocks then become one
    tensor on the object's device first. Under a mesh the graph holds the
    steps' band all-reduces (NCCL only, ``graphs.Program``). Any other
    callable runs the loop, one step at a time, on whatever device its
    tensors are."""
    if len(blocks) == 0:
        raise ValueError("scan_blocks needs at least one block")
    owner, version = _versioned_owner(step_fn)
    if owner is None or not graphs._graphed(owner.device):
        return _scan(step_fn, state, blocks)
    blocks = as_device_tensor(blocks, owner.device)
    leaves, spec = pytree.tree_flatten(state)
    key = ("scan_blocks", step_fn.__name__, blocks.shape[0],
           tuple(blocks.shape[1:]), blocks.dtype, str(spec),
           tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
                 else t for t in leaves), owner.device, version)
    layout = getattr(getattr(owner, "pqmf", owner), "_layout", None)
    return graphs.call(owner._graphs, key,
                       functools.partial(_scan, step_fn), state, blocks,
                       group=None if layout is None else layout.group)
