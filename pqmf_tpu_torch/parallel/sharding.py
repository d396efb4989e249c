"""The (data, band) mesh: SPMD over ``torch.distributed``.

Counterpart of ``pqmf_tpu/parallel/sharding.py``. The JAX package lays its
programs over a ``jax.sharding.Mesh`` from one controller; here one process
runs on each device, and the mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "band")`` over the process group the caller
initialised (NCCL on the card; gloo serves the CPU and several processes
sharing one card). The two axes are the JAX package's:

- **data** <- the batch (the reference's Python recursion over batch items,
  pqmf.py:248-249);
- **band** <- the independent per-band pitch shifters (the reference's
  unrolled loop, 1-PitchShifterWrapper.py:249-292).

Every rank runs K1/K2 (K1t/K2t) on its even band shard and the synthesis
sums over the band group with one ``all_reduce``
(``streaming.shard_band_analysis`` / ``shard_band_synthesis``); the
wrappers' middles run on each rank's bands. A global value is a ``DTensor``
over the mesh (``streaming.BandLayout``).
"""

from __future__ import annotations

import copy
import math

import torch

from pqmf_tpu_torch.kernels.polyphase import check_band_mesh
from pqmf_tpu_torch.streaming import BandLayout, StreamingPQMF

__all__ = ["mesh_shape", "make_mesh", "ShardedPitchShift"]


def mesh_shape(n_devices: int, n_band: int = 16) -> tuple:
    """The (data, band) shape of a mesh over ``n_devices``: the band axis
    gets the largest divisor of ``n_band`` that divides the devices
    (``gcd``), the data axis the rest."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs a device, got n_devices={n_devices}")
    band = math.gcd(n_devices, n_band)
    return n_devices // band, band


def make_mesh(n_devices: int | None = None, n_band: int = 16,
              device_type: str = "cuda"):
    """Build a (data, band) ``DeviceMesh`` over the first ``n_devices``
    ranks of the default process group (all of them by default), shaped by
    :func:`mesh_shape`. The caller initialises the process group and so
    picks its backend (``torch.distributed.init_process_group("nccl")``
    under ``torchrun --nproc-per-node=N``); every rank of the group calls
    this. Without an initialised default group it raises: no silent
    one-process mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group first (one process a "
            "device, e.g. under torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} outside 1..{world}, the "
                         f"process group's size")
    data, band = mesh_shape(n, n_band)
    ranks = torch.arange(n).reshape(data, band)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "band"))


class ShardedPitchShift:
    """The flagship pitch-shift step laid out over a (data, band) mesh.

    Input  x [B, 1, T]      -> split over data (when B divides by it)
    Bands  [B, M, Tb]       -> split over data and band: every rank
                               stretches only its bands
    Output y [B, T]         -> split over data, replicated over band
    Crossfade tail [M, L]   -> split over band

    ``__call__(prev_tail, x) -> (tail', y)``, both ``DTensor`` s; on the card
    the step is the view's CUDA graph (one per rank per shape), which holds
    the band ``all_reduce`` (NCCL only); ``eager`` is the same step without
    a graph. The caller's wrapper is not mutated: this view takes a
    shallow copy with a filterbank rebuilt for the mesh that carries the
    wrapper's current (restored or fine-tuned) weights. A mesh whose band
    shards would be odd keeps the kernels and the middle unsharded over
    band (every rank runs every band, the tail replicated), which is
    correct, just not band-parallel; ``PQMF`` and ``StreamingPQMF`` refuse
    such a mesh.
    """

    def __init__(self, wrapper, mesh):
        self.mesh = mesh
        pq = wrapper.pqmf
        if pq.mesh is None:
            try:
                pq_mesh = check_band_mesh(mesh, pq.n_band)
            except ValueError:
                pq_mesh = None
            wrapper = copy.copy(wrapper)
            wrapper._graphs, wrapper._stream_ola_fns = {}, {}
            if pq_mesh is not None:
                new_pq = StreamingPQMF(
                    pq.attenuation, pq.n_band, precision=pq.precision,
                    n_channels=pq.n_channels, device=pq.device,
                    mesh=pq_mesh)
                # the ORIGINAL filterbank's weights: a restored or
                # fine-tuned bank survives the rebuild
                new_pq.set_weights(pq.params, pq.hkf, pq.hki)
                wrapper.pqmf = new_pq
                wrapper._state = wrapper.init_state()
        self.wrapper = wrapper
        self.layout = (wrapper.pqmf._layout
                       or BandLayout(mesh, wrapper.n_band, split_bands=False))

    def init_state(self):
        """The zero crossfade tail [M, L], a DTensor split over band."""
        lay = self.layout
        tail = torch.zeros((lay.Mb, self.wrapper.band_overlap),
                           device=self.wrapper.device)
        return lay.wrap(tail, band_dim=0)

    def _step(self, prev_tail, x, graphed: bool):
        w = self.wrapper
        state, y = w._pitchshift_sharded(self.layout, {"prev_tail":
                                                       prev_tail},
                                         w._block(x), graphed)
        return state["prev_tail"], y

    def __call__(self, prev_tail, x):
        return self._step(prev_tail, x, graphed=True)

    def eager(self, prev_tail, x):
        """The step without a CUDA graph (gloo on the card, or a check of
        the graph)."""
        return self._step(prev_tail, x, graphed=False)
