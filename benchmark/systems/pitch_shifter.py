"""The flagship, ``pqmf_tpu_torch.PQMFPitchShiftWrapper``: what its modes
share (``wrapper``) and its check against ``reference.pitch_shift``.

Each traffic mode is a file of its own, ``pitch_shifter.<mode>.py``, with
``build`` and ``check``: ``streams`` (many streams a call) and ``live``
(one stream, a block a call). A host block is handed over as the program
takes host data: a NumPy view of a pageable float32 tensor, which the
program copies to the card (``as_tensor``).
"""

from __future__ import annotations

import math

import torch


def wrapper(config: dict, device):
    """The configuration's ``PQMFPitchShiftWrapper`` on ``device``."""
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper

    return PQMFPitchShiftWrapper(
        config["attenuation"], config["n_band"], config["m_buffer_size"],
        config["sample_rate"], config["shifts_in_semitones"],
        precision=config["precision"], phase_rule=config["phase_rule"],
        device=device)


def _geometry(config: dict) -> dict:
    from benchmark.reference import pitch_shift

    geo = pitch_shift.geometry(config["m_buffer_size"], config["n_band"])
    if geo != config["stft"]:
        raise ValueError(f"the configuration's STFT {config['stft']} is not "
                         f"the wrapper's {geo}")
    return geo


def reference(config: dict, x, x_prev, tf32: bool = False, rows: int = 32):
    """The reference's output for blocks x [R, T] after ``x_prev`` (or
    None), in blocks of ``rows`` rows."""
    from benchmark.reference import bank, pitch_shift

    hk = bank.design(config["attenuation"], config["n_band"])
    geo = _geometry(config)
    shifts = config["shifts_in_semitones"]
    return torch.cat([
        pitch_shift.step(x[i:i + rows],
                         None if x_prev is None else x_prev[i:i + rows],
                         hk, shifts, geo, tf32)
        for i in range(0, x.shape[0], rows)])


def rel_err(y: torch.Tensor, r: torch.Tensor) -> list:
    """Per row of r: ||y - r|| / ||r||; infinite where y's shape differs."""
    if tuple(y.shape) != tuple(r.shape):
        return [math.inf] * r.shape[0]
    return ((y - r).norm(dim=-1) / r.norm(dim=-1)).tolist()


def check(config: dict, pool: list, kept: list, device,
          tf32: bool = False) -> list:
    """Every kept answer (call index, outputs) against the reference, one
    dict of numbers a distinct stream block: a stream's block after the
    same previous block is the same answer however often the window
    served it, so its copies count once, by the worst of them.
    ``rel_err``: that block's; ``stream_rel_err``: the least of its
    stream's distinct blocks, which only a stream wrong in every block
    raises. ``tf32``: the control's outputs in the program's place (the
    reference at TF32)."""
    refs = {}

    def ref(key, tf32=False):
        if (key, tf32) not in refs:
            x = pool[key[0]].to(device)
            x_prev = None if key[1] is None else pool[key[1]].to(device)
            refs[key, tf32] = reference(config, x, x_prev, tf32)
        return refs[key, tf32]

    worst = {}
    for g, (y,) in kept:
        key = (g % len(pool), None if g == 0 else (g - 1) % len(pool))
        y = ref(key, tf32=True) if tf32 else y.to(device)
        for row, e in enumerate(rel_err(y, ref(key))):
            old = worst.get((key, row), -1.0)
            worst[key, row] = e if (e != e or e > old) else old
    least = {}
    for (_, row), e in worst.items():
        least[row] = min(e, least.get(row, math.inf))
    return [{"rel_err": e, "stream_rel_err": least[row]}
            for (_, row), e in worst.items()]
