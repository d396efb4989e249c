"""The bank's ``files`` mode: ``rows`` clips of ``seconds_of_audio`` on the
card, one ``pqmf_tpu_torch.PQMF.roundtrip`` call (the offline polyphase
round trip) on the batch [rows, 1, T], then a synchronize."""

from __future__ import annotations

import torch

from benchmark.systems.filterbank import rel


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        from pqmf_tpu_torch import PQMF

        M = int(config["n_band"])
        self.rows = int(traffic["rows"])
        T = int(round(traffic["seconds_of_audio"] * config["sample_rate"]))
        self.block = T - T % M
        self.device = device
        self.pq = PQMF(config["attenuation"], M,
                       polyphase=config["polyphase"],
                       precision=config["precision"], device=device)

    def reset(self):
        """Nothing is carried from call to call."""

    def call(self, x):
        y = self.pq.roundtrip(x[:, None, :])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return (y,)


def build(config: dict, traffic: dict, device) -> Program:
    return Program(config, traffic, device)


def check(config: dict, pool: list, kept: list, device,
          tf32: bool = False) -> list:
    """Every kept call's clips against the reference's round trip, one
    dict of numbers a clip. ``tf32``: the control's outputs in the
    program's place (the reference at TF32)."""
    from benchmark.reference import bank

    hk = bank.design(config["attenuation"], config["n_band"])
    answers = []
    for g, (y,) in kept:
        x = pool[g % len(pool)].to(device)
        for b in range(x.shape[0]):
            r = bank.polyphase_roundtrip(x[b:b + 1], hk)
            yb = (bank.polyphase_roundtrip(x[b:b + 1], hk, tf32=True)
                  if tf32 else y[b].to(device))
            answers.append({"rel_err": rel(yb, r)})
    return answers
