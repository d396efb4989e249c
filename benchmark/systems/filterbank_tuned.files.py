"""The fine-tuned bank's ``files`` mode: ``filterbank.files``'s program
(``rows`` clips of ``seconds_of_audio`` on the card, one
``pqmf_tpu_torch.PQMF.roundtrip`` call on [rows, 1, T], then a
synchronize) with the committed bank installed, each clip checked against
the plain round trip of the same bank."""

from __future__ import annotations

from benchmark import harness
from benchmark.systems import filterbank_tuned
from benchmark.systems.filterbank import rel

_files = harness._module(harness.ROOT / "systems" / "filterbank.files.py")


class Program(_files.Program):
    def __init__(self, config: dict, traffic: dict, device):
        super().__init__(config, traffic, device)
        filterbank_tuned.install(self.pq, config)


def build(config: dict, traffic: dict, device) -> Program:
    return Program(config, traffic, device)


def check(config: dict, pool: list, kept: list, device,
          tf32: bool = False) -> list:
    """Every kept call's clips against the reference's round trip with the
    committed bank, one dict of numbers a clip. ``tf32``: the control's
    outputs in the program's place (the reference at TF32)."""
    from benchmark.reference import bank

    hk = filterbank_tuned.bank(config)
    answers = []
    for g, (y,) in kept:
        x = pool[g % len(pool)].to(device)
        for b in range(x.shape[0]):
            r = bank.polyphase_roundtrip(x[b:b + 1], hk)
            yb = (bank.polyphase_roundtrip(x[b:b + 1], hk, tf32=True)
                  if tf32 else y[b].to(device))
            answers.append({"rel_err": rel(yb, r)})
    return answers
