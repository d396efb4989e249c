"""Plain loader of a committed fine-tuned bank: the ``hk`` [M, P] array
of ``pqmf_tpu/data/<name>.npz``, read by path with NumPy.

A fine-tuned bank is learnt tap by tap, so it is no longer a cosine
modulation of one prototype and cannot be designed here (``bank.design``);
it is read as the file holds it. The round trip is then
``bank.polyphase_roundtrip(x, load(name))``, which takes any bank [M, P].
Nothing of ``pqmf_tpu_torch`` nor of the JAX package is imported: the file
is data, found beside the JAX package's sources.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["BANK_DIR", "path", "load"]

BANK_DIR = Path(__file__).resolve().parents[2] / "pqmf_tpu" / "data"


def path(name: str) -> Path:
    """The committed file of the bank ``name``."""
    return BANK_DIR / f"{name}.npz"


def load(name: str) -> np.ndarray:
    """The bank ``hk`` [M, P] of the committed file ``name``, float32."""
    with np.load(path(name)) as z:
        hk = np.ascontiguousarray(z["hk"], dtype=np.float32)
    if hk.ndim != 2 or hk.shape[1] % hk.shape[0]:
        raise ValueError(f"bank {name!r}: hk of shape {hk.shape} is not "
                         "[M, P] with P a multiple of M")
    return hk
