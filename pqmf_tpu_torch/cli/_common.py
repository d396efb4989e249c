"""Shared helpers for the CLI entry points."""

from __future__ import annotations


def install_finetuned_bank(wrapper, attenuation: int, n_band: int) -> str:
    """Install the committed fine-tuned bank matching ``(attenuation,
    n_band)`` on ``wrapper.pqmf`` (any of the three wrappers, on its own
    device) and return the bank name. Raises FileNotFoundError, naming the
    available banks, when no committed bank matches."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank
    from pqmf_tpu_torch.streaming import kernels_from_params

    name = f"hk{n_band}_atten{attenuation}_finetuned"
    params = load_pretrained_bank(name)
    wrapper.pqmf.set_weights(
        params, *kernels_from_params(params, wrapper.pqmf.device))
    return name


def parse_shifts(text: str | None, n_band: int, seed, low: float,
                 high: float) -> list[float]:
    """``--shifts s0,s1,...`` as floats, or ``n_band`` draws from
    uniform(low, high) of ``np.random.default_rng(seed)`` (the reference
    draws its per-band shifts at random)."""
    if text is not None:
        return [float(s) for s in text.split(",")]
    import numpy as np

    rng = np.random.default_rng(seed)
    return [float(s) for s in rng.uniform(low, high, n_band)]
