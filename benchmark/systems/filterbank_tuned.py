"""A committed fine-tuned bank used bare. The program is the ``filterbank``
system's, with the bank the configuration's ``weights`` names installed
through the port's normal ``PQMF.set_weights(load_pretrained_bank(name))``
in place of the designed one; the check holds it to the plain reference
fed the same committed bank (``reference.tuned_bank``) in place of
``bank.design``. Modes: ``files`` (``filterbank_tuned.files.py``)."""

from __future__ import annotations


def bank(config: dict):
    """The reference's bank: ``hk`` [M, P] of the committed file."""
    from benchmark.reference import tuned_bank

    hk = tuned_bank.load(config["weights"])
    if hk.shape[0] != int(config["n_band"]):
        raise ValueError(f"bank {config['weights']!r} has {hk.shape[0]} "
                         f"bands, the configuration {config['n_band']}")
    return hk


def install(pq, config: dict) -> None:
    """Install the committed bank in the port's ``PQMF`` ``pq``."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    pq.set_weights(load_pretrained_bank(config["weights"]))
