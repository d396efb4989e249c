"""Export / artifact layer: save a wrapper to a directory and load it back.

Counterpart of ``pqmf_tpu/export.py``'s :func:`save_artifact` and
:func:`load_artifact`, in the same framework-neutral format, so each
package loads the other's artifacts:

- ``manifest.json`` — format_version 1, kind, config (the
  output-changing knobs), the conTorchionist method/attribute registry;
- ``weights.npz``   — every derived bank (``h``, ``hk``, ``hk_poly``,
  ``hk_ipoly``, the streaming kernels ``hkf``/``hki``; the flagship's
  fades and rates too), so loading never re-runs the design chain;
- ``state.npz``     — the flagship's crossfade state (``prev_tail``).

Three kinds: ``PQMFWrapper``, ``PQMFPitchShiftWrapper`` and
``PQMFPitchShiftWrapperTA`` (config with ``sample_rate`` and
``shifts_in_semitones``, weights only: it carries no state). Not ported
yet (ROADMAP queue 1, item 11): the ahead-of-time program
(``with_stablehlo=True`` in the JAX package; a TorchScript or
``torch.export`` form here), which raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from pqmf_tpu_torch.pipelines import (PQMFPitchShiftWrapper,
                                      PQMFPitchShiftWrapperTA, PQMFWrapper)

__all__ = ["save_artifact", "load_artifact"]

_KNOWN_CONFIG = {"attenuation", "n_band", "m_buffer_size", "precision",
                 "sample_rate", "shifts_in_semitones", "phase_rule",
                 "max_buffer_size"}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _weights_of(wrapper) -> dict:
    pq = wrapper.pqmf
    w = {k: _np(pq.params[k]) for k in ("h", "hk", "hk_poly", "hk_ipoly")}
    w["hkf"] = _np(pq.hkf)
    w["hki"] = _np(pq.hki)
    if isinstance(wrapper, PQMFPitchShiftWrapper):
        w["fade_out"] = _np(wrapper._fade_out)
        w["fade_in"] = _np(wrapper._fade_in)
        w["rates"] = _np(wrapper._rates)
    return w


def save_artifact(wrapper, path: str, with_stablehlo: bool = False) -> str:
    """Serialize a :class:`PQMFWrapper`, :class:`PQMFPitchShiftWrapper` or
    :class:`PQMFPitchShiftWrapperTA` to an artifact directory; returns the
    path."""
    if with_stablehlo:
        raise ValueError(
            "with_stablehlo=True is not ported: the ahead-of-time form "
            "(TorchScript / torch.export) waits for ROADMAP queue 1, "
            "item 11")
    kind = type(wrapper).__name__
    if not isinstance(wrapper, (PQMFWrapper, PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA)):
        raise ValueError(
            f"no artifact for {kind}: the port saves PQMFWrapper, "
            "PQMFPitchShiftWrapper and PQMFPitchShiftWrapperTA")
    from pqmf_tpu_torch import __version__

    manifest = {
        "format_version": 1,
        "framework_version": __version__,
        "kind": kind,
        "platform": wrapper.device.type,
        "config": {
            "attenuation": wrapper.attenuation,
            "n_band": wrapper.n_band,
            "m_buffer_size": wrapper.m_buffer_size,
            "precision": wrapper.pqmf.precision,
            # None (offline-unbounded) rides here: attribute_values drops it
            "max_buffer_size": wrapper.max_buffer_size,
        },
        "methods": wrapper.get_methods(),
        "attributes": wrapper.get_attributes(),
        "attribute_values": {
            k: v for k, v in wrapper.attribute_dict().items()
            if isinstance(v, (int, float, str))
        },
    }
    os.makedirs(path, exist_ok=True)
    if isinstance(wrapper, PQMFPitchShiftWrapper):
        manifest["config"]["sample_rate"] = wrapper.sample_rate
        manifest["config"]["shifts_in_semitones"] = list(wrapper.shifts)
        manifest["config"]["phase_rule"] = wrapper.phase_rule
        manifest["state_spec"] = {
            "prev_tail": [wrapper.n_band, wrapper.band_overlap]}
        np.savez(os.path.join(path, "state.npz"),
                 prev_tail=_np(wrapper._state["prev_tail"]))
    elif isinstance(wrapper, PQMFPitchShiftWrapperTA):
        manifest["config"]["sample_rate"] = wrapper.sample_rate
        manifest["config"]["shifts_in_semitones"] = list(wrapper.shifts)
    np.savez(os.path.join(path, "weights.npz"), **_weights_of(wrapper))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def load_artifact(path: str, device="cuda"):
    """Rebuild a wrapper on ``device`` from an artifact directory (saved by
    this package or by ``pqmf_tpu``): the weights load as they are (no
    design-chain rerun) and the state is restored. Returns
    ``(wrapper, manifest)``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "weights.npz")) as z:
        weights = dict(z)
    cfg = manifest["config"]
    kind = manifest["kind"]
    unknown = set(cfg) - _KNOWN_CONFIG
    if unknown:
        warnings.warn(
            f"artifact config keys {sorted(unknown)} are not understood by "
            "pqmf_tpu_torch; the reloaded wrapper may differ from the "
            "exported one", stacklevel=2)
    common = dict(precision=cfg.get("precision", "highest"),
                  # artifacts without the key declared no limit
                  max_buffer_size=cfg.get("max_buffer_size"), device=device)
    if kind == "PQMFWrapper":
        wrapper = PQMFWrapper(cfg["attenuation"], cfg["n_band"],
                              cfg["m_buffer_size"], **common)
    elif kind == "PQMFPitchShiftWrapper":
        wrapper = PQMFPitchShiftWrapper(
            cfg["attenuation"], cfg["n_band"], cfg["m_buffer_size"],
            cfg.get("sample_rate", 44100), cfg.get("shifts_in_semitones"),
            phase_rule=cfg.get("phase_rule", "reference"), **common)
    elif kind == "PQMFPitchShiftWrapperTA":
        wrapper = PQMFPitchShiftWrapperTA(
            cfg["attenuation"], cfg["n_band"], cfg["m_buffer_size"],
            cfg.get("sample_rate", 44100), cfg.get("shifts_in_semitones"),
            **common)
    else:
        raise ValueError(f"unknown artifact kind {kind}")
    wrapper.pqmf.set_weights(
        {k: weights[k] for k in ("h", "hk", "hk_poly", "hk_ipoly")},
        weights["hkf"], weights["hki"])
    state_path = os.path.join(path, "state.npz")
    if kind == "PQMFPitchShiftWrapper" and os.path.exists(state_path):
        with np.load(state_path) as st:
            wrapper._state = {"prev_tail": torch.tensor(
                st["prev_tail"], dtype=torch.float32,
                device=wrapper.device)}
    return wrapper, manifest
