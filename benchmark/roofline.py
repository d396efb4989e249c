"""The card's peaks and the work of the operations the cells time, counted
from the configuration's shapes (never from what a kernel happens to do).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s. A
card set below 700 W runs slower: ``run.py`` prints its ``power.limit``
beside every result.
"""

from __future__ import annotations

from benchmark.reference import bank

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def polyphase_roundtrip_work(B: int, T: int, M: int, P: int) -> tuple:
    """(FLOP, bytes) of the offline polyphase analysis then synthesis of B
    signals of T samples with an M-band bank of P taps (L = P / M a
    phase): each half B T M L multiply-adds, 2 FLOP each; the signal read
    and written once and both banks (M M L floats each) read once, float32.
    """
    L = P // M
    flop = 2 * (2 * B * T * M * L)
    nbytes = 4 * (2 * B * T + 2 * M * M * L)
    return flop, nbytes


def bound_seconds(flop: float, nbytes: float) -> tuple:
    """(seconds, "operations" | "bytes"): the least time at the peaks."""
    ops, mem = flop / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def polyphase_roundtrip(config: dict, rows: int, samples: int) -> tuple:
    """The bound of one ``PQMF.roundtrip`` call on [rows, 1, samples]."""
    M = int(config["n_band"])
    P = bank.design(config["attenuation"], M).shape[-1]
    return bound_seconds(*polyphase_roundtrip_work(rows, samples, M, P))
