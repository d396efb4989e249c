"""What the port's demos share: the repository on ``sys.path``, bench.py's
test signal and the card's ``nvidia-smi`` line."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

SR = 44100
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def bench_signal(seconds: float) -> np.ndarray:
    """bench.py's test signal (a 440 Hz sine plus seeded noise), [1, n]
    float32; copied here, the demos import nothing of the JAX package."""
    n = int(round(seconds * SR))
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / SR
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.1 * rng.standard_normal(n).astype(np.float32))
    return x.astype(np.float32)[None]


def load_input(path: str | None, seconds: float) -> tuple[np.ndarray, int]:
    """The first channel of the wav at ``path`` ([1, n] float32, its rate),
    or bench.py's signal of ``seconds`` at 44.1 kHz."""
    if path is None:
        return bench_signal(seconds), SR
    from pqmf_tpu_torch.utils.audio import read_wav

    x, sr = read_wav(path)
    return x[:1].astype(np.float32), sr


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU."""
    if str(device).startswith("cpu"):
        return "device: cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return f"card: {out}"
