"""pqmf_tpu_torch — the PyTorch + CUDA port of ``pqmf_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference every part
of the port is tested against. Ported:

- the streaming PQMF filterbank (:class:`StreamingPQMF`) on three
  hand-written CUDA kernels, K1/K2/K3 (``kernels/cached_conv.py``,
  ``csrc/cached_conv.cu``);
- the offline PQMF (:class:`PQMF`, polyphase and classic) on the polyphase
  adapters K4/K5/K6 over those kernels (``kernels/polyphase.py``);
- the plain wrapper (:class:`PQMFWrapper`), the flagship per-sub-band
  phase-vocoder pitch shifter (:class:`PQMFPitchShiftWrapper`) and the
  torchaudio variant (:class:`PQMFPitchShiftWrapperTA`), their artifacts
  (:func:`save_artifact`, :func:`load_artifact`) and the ahead-of-time
  ``torch.export`` program of each one's block method
  (``export.export_stablehlo`` / ``load_stablehlo``), whose convs are the
  kernels as ``torch.library`` operators (``torch.ops.pqmf_tpu_torch``);
- the standalone shifters (``shifters.py``) and the block-streaming
  harness (:func:`stream_ola`);
- filterbank fine-tuning (``parallel.training``: ``finetune_filterbank``,
  ``make_train_step``, ``TrainablePQMF``, checkpoints in the JAX package's
  layout) and ``models``, the wrappers' re-export;
- the (data, band) mesh over ``torch.distributed``
  (``parallel.sharding``: ``make_mesh``, ``ShardedPitchShift``; ``mesh=``
  on every entry point the JAX package gives one);
- the CLIs ``cli.export_pqmf``, ``cli.export_pvoc``, ``cli.vocoder``,
  ``cli.ps_torchaudio``, ``cli.blocks`` and ``cli.finetune_bank``.

:func:`params_from_jax` carries a bank over from ``pqmf_tpu``. Nothing here
imports JAX.
"""

from pqmf_tpu_torch import design
from pqmf_tpu_torch.convert import params_from_jax
from pqmf_tpu_torch.export import load_artifact, save_artifact
from pqmf_tpu_torch.filterbank import PQMF
from pqmf_tpu_torch.pipelines import (PQMFPitchShiftWrapper,
                                      PQMFPitchShiftWrapperTA, PQMFWrapper,
                                      stream_ola)
from pqmf_tpu_torch.shifters import (PhaseVocoderPitchShift, PitchShifter,
                                     ResamplePitchShift,
                                     TorchaudioPitchShift)
from pqmf_tpu_torch.streaming import StreamingPQMF

__version__ = "0.3.0"

__all__ = [
    "design",
    "PQMF",
    "StreamingPQMF",
    "PQMFWrapper",
    "PQMFPitchShiftWrapper",
    "PQMFPitchShiftWrapperTA",
    "stream_ola",
    "PhaseVocoderPitchShift",
    "ResamplePitchShift",
    "TorchaudioPitchShift",
    "PitchShifter",
    "save_artifact",
    "load_artifact",
    "params_from_jax",
    "__version__",
]
