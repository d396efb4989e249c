"""The committed fine-tuned banks.

Counterpart of ``pqmf_tpu/parallel/training.py``'s
:func:`load_pretrained_bank` and :func:`available_pretrained_banks`. The
banks are the JAX package's files, ``pqmf_tpu/data/<name>.npz``, read by
path (importing ``pqmf_tpu`` would import JAX); each loads as a params dict
of NumPy arrays for ``set_weights``. See the JAX docstring for how they
were trained and what they measure. Fine-tuning itself is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pqmf_tpu_torch.ops import filterbank as fb

__all__ = ["BANK_DIR", "load_pretrained_bank", "available_pretrained_banks"]

BANK_DIR = Path(__file__).resolve().parents[2] / "pqmf_tpu" / "data"


def available_pretrained_banks() -> list[str]:
    """Names accepted by :func:`load_pretrained_bank`."""
    return sorted(p.stem for p in BANK_DIR.glob("*.npz"))


def load_pretrained_bank(name: str = "hk16_atten100_finetuned") -> dict:
    """A committed fine-tuned bank as a params dict ``{h, hk, hk_poly,
    hk_ipoly}`` (float32 NumPy), derived from its ``hk`` exactly as the JAX
    package derives it."""
    path = BANK_DIR / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"no committed bank named {name!r}; available: "
            f"{available_pretrained_banks()}")
    with np.load(path) as z:
        return fb.params_from_hk(z["hk"],
                                 h=z["h"] if "h" in z.files else None)
