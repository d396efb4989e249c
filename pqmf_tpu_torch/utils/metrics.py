"""Quality metrics — the ONE definition site for round-trip SNR.

Two round-trip SNR definitions exist in this repo, and both are needed;
what matters is that every consumer names which one it reports
(VERDICT r4 weak #2: BENCH_r03 -> r04 silently switched the fine-tuned
bank number from whole-signal to steady-state, 67.8 -> 104.3 dB, which
read as a quality jump that didn't happen):

- **whole-signal** (``edge_trim=0``): SNR over the full delay-aligned
  output, INCLUDING the filterbank's O(bank-length) edge transients.
  This is the number to quote against the reference design's intrinsic
  floor (54.81 dB on flute.wav — identical to float32 round-off between
  the torch oracle, the lax path, and the Pallas kernels) and the value
  BENCH rounds 1-3 recorded.

- **steady-state** (``edge_trim=len(bank)``): one bank length trimmed
  from each edge before the ratio. The edge transient is a fixed
  O(P)-sample artifact of where the file happens to end, not a property
  of the bank — on flute.wav (which ends loud) the last 512 samples
  alone carried 95% of the whole-file error, swamping a 104.9 dB
  interior. Every committed fine-tuned-bank pin (README, tools/
  tpu_checks.py, tests/test_parallel.py) uses this definition, via
  ``parallel.training.streaming_roundtrip_snr`` which routes here.

Cross-round comparisons must compare like against like; bench.py's JSON
carries a ``snr_definitions`` map naming the definition per key.
"""

from __future__ import annotations

import numpy as np

__all__ = ["snr_db", "aligned_roundtrip_snr_db"]


def snr_db(ref, got) -> float:
    """10·log10(Σref² / Σ(ref−got)²) in float64; inf on exact equality."""
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    err = ref - got
    denom = float(np.sum(err ** 2))
    if denom == 0.0:
        return float("inf")
    return float(10 * np.log10(float(np.sum(ref ** 2)) / denom))


def aligned_roundtrip_snr_db(x, y, delay: int, edge_trim: int = 0) -> float:
    """Round-trip SNR of output ``y`` against input ``x`` (1-D arrays),
    aligned by the path's constant group ``delay`` (samples), with
    ``edge_trim`` samples dropped from each end AFTER alignment.

    ``edge_trim=0`` is the whole-signal definition; ``edge_trim=len(hk)``
    (one bank length) is the steady-state definition — see the module
    docstring for when each applies.

    ``x`` and ``y`` may differ in length by at most ``delay`` samples
    (a path may emit its constant latency as extra tail samples or trim
    it, both legitimate); a larger mismatch means the PATH dropped or
    grew samples — a bug this metric must surface, not silently
    truncate into a plausible-looking SNR (review r5; the inline code
    this replaced crashed on broadcast instead)."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if abs(x.shape[-1] - y.shape[-1]) > delay:
        raise ValueError(
            f"length mismatch: x has {x.shape[-1]} samples, y has "
            f"{y.shape[-1]} (> delay={delay} apart) — the path under "
            "test dropped or grew samples beyond its declared latency")
    ya = y[delay:]
    xa = x[: x.shape[-1] - delay] if delay else x
    n = min(len(xa), len(ya))
    xa, ya = xa[:n], ya[:n]
    if edge_trim:
        if 2 * edge_trim >= n:
            raise ValueError(
                f"edge_trim={edge_trim} leaves no samples of the "
                f"{n}-sample aligned signal")
        xa, ya = xa[edge_trim:-edge_trim], ya[edge_trim:-edge_trim]
    return snr_db(xa, ya)
