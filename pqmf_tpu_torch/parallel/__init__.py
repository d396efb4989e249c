"""Parallelism and training of the port: ``sharding`` (the (data, band)
mesh over ``torch.distributed``: ``make_mesh``, ``ShardedPitchShift``) and
``training`` (the differentiable bank, its fine-tuning, data-parallel over
a mesh, and the committed fine-tuned banks)."""

from pqmf_tpu_torch.parallel import sharding, training

__all__ = ["sharding", "training"]
