"""Export / artifact layer: save a wrapper to a directory and load it back.

Counterpart of ``pqmf_tpu/export.py``'s :func:`save_artifact`,
:func:`load_artifact`, :func:`export_stablehlo` and :func:`load_stablehlo`,
with the same names and signatures, so a caller ports by changing the
import. The wrapper files are the JAX package's framework-neutral format,
so each package loads the other's artifacts as wrappers:

- ``manifest.json`` — format_version 1, kind, config (the
  output-changing knobs), the conTorchionist method/attribute registry;
- ``weights.npz``   — every derived bank (``h``, ``hk``, ``hk_poly``,
  ``hk_ipoly``, the streaming kernels ``hkf``/``hki``; the flagship's
  fades and rates too), so loading never re-runs the design chain;
- ``state.npz``     — the flagship's crossfade state (``prev_tail``);
- ``<method>.pt2`` (optional, ``with_stablehlo=True``) — the ahead-of-time
  program of the wrapper's block method at one block length: a
  ``torch.export`` program (``torch.export.save``), NOT StableHLO. Its ops
  are ATen's and the kernel operators of ``kernels/cached_conv.py``
  (``pqmf_tpu_torch::analysis_conv`` / ``synthesis_conv``) and, in the
  flagship's, of ``kernels/middle.py`` (``pv_frame`` / ``pv_spectral`` /
  ``pv_resynth``), so a reloaded program launches the same hand-written
  kernels as the live wrapper. The
  manifest records it under ``"torch_export"`` (with the block length and
  the device type it was exported on), never under JAX's ``"stablehlo"``:
  neither package's :func:`load_stablehlo` takes the other's program.

Three kinds: ``PQMFWrapper``, ``PQMFPitchShiftWrapper`` and
``PQMFPitchShiftWrapperTA`` (config with ``sample_rate`` and
``shifts_in_semitones``, weights only: it carries no state).
"""

from __future__ import annotations

import io
import json
import os
import warnings

import numpy as np
import torch

from pqmf_tpu_torch import graphs
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.pipelines import (PQMFPitchShiftWrapper,
                                      PQMFPitchShiftWrapperTA, PQMFWrapper)
from pqmf_tpu_torch.streaming import resolve_device

__all__ = ["save_artifact", "load_artifact", "export_stablehlo",
           "load_stablehlo"]

# wrapper kind -> the AOT-exported method (and the program's file stem),
# as in the JAX package
_AOT_METHOD = {
    "PQMFPitchShiftWrapper": "pitchshift",
    "PQMFPitchShiftWrapperTA": "pitchshifter",
    "PQMFWrapper": "process",
}
_PROGRAM_EXT = ".pt2"
_MANIFEST_KEY = "torch_export"

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


def save_artifact(wrapper, path: str, with_stablehlo: bool = False,
                  example_length: int | None = None) -> str:
    """Serialize a :class:`PQMFWrapper`, :class:`PQMFPitchShiftWrapper` or
    :class:`PQMFPitchShiftWrapperTA` to an artifact directory; returns the
    path. ``with_stablehlo=True`` adds the ``torch.export`` program of the
    wrapper's block method (:func:`export_stablehlo`) at
    ``example_length`` samples (default ``m_buffer_size``) as
    ``<method>.pt2``.

    The export runs before any file is written: a failed export raises
    ``RuntimeError`` and leaves the directory as it was (none is created).
    A save without the program removes a program this package wrote there
    earlier (its ``<method>.pt2`` names only), so a stale program never
    sits beside new weights."""
    kind = type(wrapper).__name__
    if not isinstance(wrapper, (PQMFWrapper, PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA)):
        raise ValueError(
            f"no artifact for {kind}: the port saves PQMFWrapper, "
            "PQMFPitchShiftWrapper and PQMFPitchShiftWrapperTA")
    program = None
    if with_stablehlo:
        T = int(example_length or wrapper.m_buffer_size)
        method = _AOT_METHOD[kind]
        try:
            program = export_stablehlo(wrapper, T)
        except Exception as e:
            # the caller asked for an AOT artifact: no wrapper-only
            # downgrade
            raise RuntimeError(
                f"torch.export program requested but failed on "
                f"{wrapper.device}") from e
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
    for fn in os.listdir(path):  # only this package's program names
        stem, ext = os.path.splitext(fn)
        if ext == _PROGRAM_EXT and stem in _AOT_METHOD.values():
            os.remove(os.path.join(path, fn))
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
    if program is not None:
        with open(os.path.join(path, method + _PROGRAM_EXT), "wb") as f:
            f.write(program)
        manifest[_MANIFEST_KEY] = {
            method: {"length": T, "device": wrapper.device.type}}
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


# ---------------------------------------------------------------------------
# the ahead-of-time program
# ---------------------------------------------------------------------------


class _Step(torch.nn.Module):
    """A wrapper's block method as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _flagship_step(wrapper):
    """The flagship's block with the JAX signature: ``(prev_tail [M, L],
    x [1, T]) -> (prev_tail', y [1, T])``."""

    def step(prev_tail, x):
        state, y = wrapper._pitchshift_fn_eager({"prev_tail": prev_tail}, x)
        return state["prev_tail"], y

    return step


def _step_of(wrapper, length: int):
    """The exported method of ``wrapper`` as a module, and its example
    arguments at B = 1 (zeros on the wrapper's device)."""
    dev = wrapper.device
    kind = type(wrapper).__name__
    if kind not in _AOT_METHOD:
        raise ValueError(f"no AOT export for {kind}")
    if isinstance(wrapper, PQMFPitchShiftWrapper):
        return _Step(_flagship_step(wrapper)), (
            torch.zeros((wrapper.n_band, wrapper.band_overlap),
                        dtype=torch.float32, device=dev),
            torch.zeros((1, length), dtype=torch.float32, device=dev))
    # the block's eager body: the public method replays a CUDA graph
    method = (wrapper._pitchshifter_eager
              if isinstance(wrapper, PQMFPitchShiftWrapperTA)
              else wrapper._process_eager)
    return _Step(method), (
        torch.zeros((1, 1, length), dtype=torch.float32, device=dev),)


def _check_signature(ep, n_inputs: int) -> None:
    """Every tensor the program reads besides its ``n_inputs`` arguments
    (banks, arranged banks, fades, rates, plan tensors) is a buffer or a
    lifted constant of the program; nothing is a parameter."""
    from torch.export.graph_signature import InputKind

    kinds = [spec.kind for spec in ep.graph_signature.input_specs]
    user = kinds.count(InputKind.USER_INPUT)
    rest = set(kinds) - {InputKind.USER_INPUT, InputKind.BUFFER,
                         InputKind.CONSTANT_TENSOR}
    if user != n_inputs or rest:
        raise RuntimeError(f"exported program reads {user} user inputs "
                           f"(expected {n_inputs}) and inputs of kinds "
                           f"{sorted(k.name for k in rest)}")


def export_stablehlo(wrapper, length: int) -> bytes:
    """Ahead-of-time export of the wrapper's block method at a fixed block
    length, as the bytes of a ``torch.export`` program
    (``torch.export.save``; NOT StableHLO, the name is the JAX package's).
    Signatures, at B = 1, as the JAX package's:

    - flagship: ``(prev_tail [M, L], x [1, length]) -> (prev_tail', y
      [1, length])``;
    - TA variant: ``x [1, 1, length] -> y [1, 1, length]``;
    - plain wrapper: ``x [1, 1, length] -> (reconstructed, subbands)``.

    The program is fixed to the wrapper's device and carries every tensor
    it reads; its convs (and the flagship's middle) are the kernel
    operators, so on the card it launches K1 and K2 (K1t/K2t at a tier),
    one of each a block, and the flagship's three middle kernels.

    The step runs once eagerly first: a plan or cached tensor that the
    trace filled would hold a FakeTensor, and the wrapper's next live call
    would return one. Warmed, the trace reads real tensors only, and they
    become constants of the program."""
    module, args = _step_of(wrapper, int(length))
    with torch.no_grad():
        module(*args)
    ep = torch.export.export(module, args)
    _check_signature(ep, len(args))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_stablehlo(path: str, method: str | None = None, device="cuda"):
    """Load an artifact's ``torch.export`` program (saved with
    ``with_stablehlo=True``) as a callable with the signature of
    :func:`export_stablehlo`, or ``None`` when the manifest declares none
    (a JAX artifact's StableHLO is never taken). ``method=None`` takes the
    artifact's one program. The manifest decides what loads: no file name
    is guessed.

    A program fixes its device, down to the card's index: one whose
    tensors lie on another device than ``device`` (``"cuda"`` is the
    current card) is refused, with no fallback. The callable takes what the
    live wrapper takes: each argument must have the dtype and lie on the
    device it was exported with (else ``ValueError``), and a strided one is
    copied contiguous, as the wrapper's checks do; the kernel operators
    check their operands again before they launch. The program runs inside
    ``ops.filterbank.full_f32()``, so it sees the TF32 and matmul settings
    of the live step.

    On the card the program is a CUDA graph a geometry of its arguments
    (shapes and dtypes; ``graphs.Program``, kept in the callable), the
    port of the JAX executable's ``exp.call``: the first call runs the
    module eagerly and captures it, later calls replay it. The checks stay
    in Python, before the program runs. The program's constants are its
    own, so no ``weights_version`` is kept. ``program.eager`` runs the
    module without the graph, after the same checks."""
    dev = resolve_device(device)
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        programs = json.load(f).get(_MANIFEST_KEY, {})
    if method is None:
        method = next(iter(programs), None)
    entry = programs.get(method)
    if entry is None:
        return None
    if entry["device"] != dev.type:
        raise ValueError(
            f"the {method!r} program of {path} was exported for "
            f"{entry['device']!r}; it cannot run on {dev.type!r}")
    with open(os.path.join(path, method + _PROGRAM_EXT), "rb") as f:
        ep = torch.export.load(f)
    user = set(ep.graph_signature.user_inputs)
    specs = [n.meta["val"] for n in ep.graph.nodes
             if n.op == "placeholder" and n.name in user]
    held = {t.device for t in (*ep.constants.values(),
                               *ep.state_dict.values())
            if isinstance(t, torch.Tensor)} | {v.device for v in specs}
    if held != {dev}:
        raise ValueError(
            f"the {method!r} program of {path} holds tensors on "
            f"{sorted(map(str, held))}; it cannot run on {dev}")
    module = ep.module()

    def run(*args):
        with torch.no_grad(), fb.full_f32():
            return module(*args)

    programs = {}  # the graphs, a geometry of the arguments each

    def checked(args) -> list:
        if len(args) != len(specs):
            raise TypeError(f"the {method!r} program takes {len(specs)} "
                            f"arguments, got {len(args)}")
        out = []
        for i, (a, spec) in enumerate(zip(args, specs)):
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"argument {i} must be a torch.Tensor, got "
                                f"{type(a)}")
            if a.dtype != spec.dtype or a.device != dev:
                raise ValueError(
                    f"argument {i} is {a.dtype} on {a.device}; the program "
                    f"takes {spec.dtype} on {dev}")
            out.append(a.contiguous())
        return out

    def program(*args):
        args = checked(args)
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = graphs.Program(run, dev)
        return prog(*args)

    program.eager = lambda *args: run(*checked(args))
    return program
