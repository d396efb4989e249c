"""Model families — the deployable processing modules.

Counterpart of ``pqmf_tpu/models/__init__.py``: the three wrappers of
:mod:`pqmf_tpu_torch.pipelines`, re-exported under ``models`` for the
conventional layout, together with the trainable filterbank.
"""

from pqmf_tpu_torch.parallel.training import TrainablePQMF
from pqmf_tpu_torch.pipelines import (PQMFPitchShiftWrapper,
                                      PQMFPitchShiftWrapperTA, PQMFWrapper)

__all__ = [
    "PQMFWrapper",
    "PQMFPitchShiftWrapper",
    "PQMFPitchShiftWrapperTA",
    "TrainablePQMF",
]
