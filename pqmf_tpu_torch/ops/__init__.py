"""Plain tensor ops of the port (the conv kernels live in ``kernels``)."""

from pqmf_tpu_torch.ops import filterbank, phase_vocoder, resample, stft

__all__ = ["filterbank", "stft", "resample", "phase_vocoder"]
