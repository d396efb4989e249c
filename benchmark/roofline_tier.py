"""The work of the flagship's products at a bf16 tier, counted from the
configuration's shapes (never from what a kernel happens to do), and the
least time the card could take for it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): bf16 on the tensor cores with float32 sums 989 TFLOP/s, HBM3
3.35 TB/s (``roofline.HBM_BYTES_PER_S``). Bytes count each float32 input
and output once; the larger of the two times is the bound.
"""

from __future__ import annotations

import math

from benchmark import roofline
from benchmark.reference import bank, pitch_shift

BF16_FLOPS = 989e12


def bound_seconds(flop: float, nbytes: float) -> tuple:
    """(seconds, "operations" | "bytes"): the least time at the peaks."""
    ops, mem = flop / BF16_FLOPS, nbytes / roofline.HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def conv_pair_work(B: int, T: int, M: int, P: int) -> tuple:
    """(FLOP, bytes) of the cached analysis then synthesis (K1t + K2t) of
    B blocks of T samples with an M-band bank of P taps: the analysis
    B T P multiply-adds (M bands, T/M outputs, P taps each), the synthesis
    B T P (M phases, T/M steps, M bands of P/M taps), 2 FLOP each; the
    block in and the sub-bands out, the crossfaded bands in and the block
    out (4 B T floats), each bank (M P floats) read once."""
    flop = 2 * (2 * B * T * P)
    nbytes = 4 * (4 * B * T + 2 * M * P)
    return flop, nbytes


def stretch_frames(config: dict, block: int) -> tuple:
    """(STFT frames of a band, output frames of each band) of a block of
    ``block`` samples: the frames of the band padded to at least n_fft,
    centred; ``max(1, floor(frames / rate))`` at rate 2 ** (-s / 12)."""
    geo = pitch_shift.geometry(config["m_buffer_size"], config["n_band"])
    n_fft, hop = geo["n_fft"], geo["hop"]
    Tb = max(block // int(config["n_band"]), n_fft)
    frames = 1 + (Tb + 2 * (n_fft // 2) - n_fft) // hop
    fo = [max(1, math.floor(frames / (1.0 / 2.0 ** (int(round(s)) / 12.0))))
          for s in config["shifts_in_semitones"]]
    return frames, fo


def dft_products_work(B: int, M: int, frames: int, fo, n_fft: int) -> tuple:
    """(FLOP, bytes) of the middle's two products for B streams of M
    bands: the STFT [B M frames, n_fft] @ [n_fft, 2F] and the ISTFT over
    the frames that exist [B sum(fo), 2F] @ [2F, n_fft], F = n_fft/2 + 1,
    2 FLOP a multiply-add; each product's rows in and out and its basis
    read once, float32."""
    F2 = 2 * (n_fft // 2 + 1)
    rows = B * M * frames + B * sum(fo)
    flop = 2 * rows * n_fft * F2
    nbytes = 4 * (rows * (n_fft + F2) + 2 * n_fft * F2)
    return flop, nbytes


def conv_pair(config: dict, rows: int, block: int) -> tuple:
    """The bound of K1t + K2t in one step of ``rows`` blocks of
    ``block``."""
    M = int(config["n_band"])
    P = bank.design(config["attenuation"], M).shape[-1]
    return bound_seconds(*conv_pair_work(rows, block, M, P))


def dft_products(config: dict, rows: int, block: int) -> tuple:
    """The bound of the middle's two products in one step of ``rows``
    blocks of ``block``."""
    frames, fo = stretch_frames(config, block)
    n_fft = pitch_shift.geometry(config["m_buffer_size"],
                                 config["n_band"])["n_fft"]
    return bound_seconds(*dft_products_work(rows, int(config["n_band"]),
                                            frames, fo, n_fft))
