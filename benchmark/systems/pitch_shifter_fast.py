"""The flagship at its fast-serving tier (``precision="default"``): the
same programs as ``pitch_shifter``'s, held to the tier's own reference,
``reference.pitch_shift_bf16``, which rounds the operands of the step's
four products to bfloat16 as the configuration's ``tier`` says.

The check's numbers are ``pitch_shifter.check``'s; ``tf32=True`` (the
control) puts in the program's place the tier's reference with every
product's result rounded to bfloat16 as well.
"""

from __future__ import annotations

import math

import torch

from benchmark.systems import pitch_shifter


def reference(config: dict, x, x_prev, tf32: bool = False, rows: int = 32):
    """The tier's reference output for blocks x [R, T] after ``x_prev`` (or
    None), in blocks of ``rows`` rows; the control's with ``tf32``."""
    from benchmark.reference import bank, pitch_shift_bf16

    hk = bank.design(config["attenuation"], config["n_band"])
    geo = pitch_shifter._geometry(config)
    shifts = config["shifts_in_semitones"]
    rounding = "control" if tf32 else "tier"
    return torch.cat([
        pitch_shift_bf16.step(x[i:i + rows],
                              None if x_prev is None else x_prev[i:i + rows],
                              hk, shifts, geo, rounding)
        for i in range(0, x.shape[0], rows)])


def check(config: dict, pool: list, kept: list, device,
          tf32: bool = False) -> list:
    """``pitch_shifter.check`` against the tier's reference: one dict of
    numbers a distinct stream block, ``rel_err`` the worst of its copies,
    ``stream_rel_err`` the least of its stream's distinct blocks."""
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
        for row, e in enumerate(pitch_shifter.rel_err(y, ref(key))):
            old = worst.get((key, row), -1.0)
            worst[key, row] = e if (e != e or e > old) else old
    least = {}
    for (_, row), e in worst.items():
        least[row] = min(e, least.get(row, math.inf))
    return [{"rel_err": e, "stream_rel_err": least[row]}
            for (_, row), e in worst.items()]
