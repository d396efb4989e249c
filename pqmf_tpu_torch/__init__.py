"""pqmf_tpu_torch — the PyTorch + CUDA port of ``pqmf_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference every part
of the port is tested against. This slice ports the main path: the
streaming PQMF filterbank (:class:`StreamingPQMF`) on three hand-written
CUDA kernels (``kernels/cached_conv.py``, ``csrc/cached_conv.cu``), and the
flagship per-sub-band phase-vocoder pitch shifter
(:class:`PQMFPitchShiftWrapper`). :func:`params_from_jax` carries a bank
over from ``pqmf_tpu``. Nothing here imports JAX.
"""

from pqmf_tpu_torch import design
from pqmf_tpu_torch.convert import params_from_jax
from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper
from pqmf_tpu_torch.streaming import StreamingPQMF

__version__ = "0.1.0"

__all__ = [
    "design",
    "StreamingPQMF",
    "PQMFPitchShiftWrapper",
    "params_from_jax",
    "__version__",
]
