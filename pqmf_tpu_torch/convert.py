"""Carry filterbank weights over from the JAX package.

``pqmf_tpu`` keeps a bank as a params pytree ``{"h", "hk", "hk_poly",
"hk_ipoly"}`` (``pqmf_tpu.ops.filterbank.params_from_hk``, the committed
fine-tuned banks, an export artifact's ``weights.npz``). Hand its leaves
over as NumPy arrays (``{k: np.asarray(v) for k, v in params.items()}``):
this module never imports JAX.

    pq = StreamingPQMF(100, 16, device="cuda")
    pq.set_weights(params_from_jax(jax_params, "cuda"))
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from pqmf_tpu_torch.streaming import resolve_device

__all__ = ["PARAM_KEYS", "params_from_jax"]

PARAM_KEYS = ("h", "hk", "hk_poly", "hk_ipoly")


def params_from_jax(params: Mapping[str, np.ndarray],
                    device="cpu") -> dict[str, torch.Tensor]:
    """The JAX package's params pytree as float32 tensors on ``device``
    (copied, so read-only arrays from JAX are fine)."""
    missing = [k for k in PARAM_KEYS if k not in params]
    if missing:
        raise KeyError(f"params lack {missing}; expected {PARAM_KEYS}")
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
            for k in PARAM_KEYS}
