"""The bank's ``live`` mode: one stream, one
``pqmf_tpu_torch.pipelines.PQMFWrapper.process`` call a [1, block] host
block (handed over as a NumPy view of a pageable tensor), both outputs
(reconstructed, sub-bands) copied back to the host."""

from __future__ import annotations

from benchmark import harness
from benchmark.systems.filterbank import rel


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        from pqmf_tpu_torch.pipelines import PQMFWrapper

        self.rows = int(traffic["rows"])
        if self.rows != 1:
            raise ValueError("a live stream has one row")
        self.block = harness.block_size(config, traffic)
        self.w = PQMFWrapper(config["attenuation"], int(config["n_band"]),
                             config["m_buffer_size"],
                             precision=config["precision"], device=device)

    def reset(self):
        """Nothing is carried from call to call."""

    def call(self, x):
        rec, sub = self.w.process(x.numpy())
        return rec.cpu(), sub.cpu()


def build(config: dict, traffic: dict, device) -> Program:
    return Program(config, traffic, device)


def check(config: dict, pool: list, kept: list, device,
          tf32: bool = False) -> list:
    """Every kept block's reconstruction and sub-bands against the
    reference's, one dict of numbers a block (the worse of the two).
    ``tf32``: the control's outputs in the program's place (the reference
    at TF32)."""
    from benchmark.reference import bank

    hk = bank.design(config["attenuation"], config["n_band"])
    refs = {}

    def ref(i, tf32=False):
        """(reconstruction, sub-bands) of pool item ``i``."""
        if (i, tf32) not in refs:
            sub = bank.analysis(pool[i].to(device), hk, tf32=tf32)
            refs[i, tf32] = bank.synthesis(sub, hk, tf32=tf32), sub
        return refs[i, tf32]

    answers = []
    for g, outs in kept:
        rec_r, sub_r = ref(g % len(pool))
        rec_y, sub_y = (ref(g % len(pool), tf32=True) if tf32
                        else (o.to(device) for o in outs))
        answers.append({"rel_err": max(rel(rec_y, rec_r),
                                       rel(sub_y, sub_r))})
    return answers
