"""Fine-tune a PQMF bank on white noise and write it as an npz.

    python -m pqmf_tpu_torch.cli.finetune_bank --n_band 16 --out hk16.npz
        [--steps 8000] [--lr 2e-5] [--batch 4] [--length 8192]
        [--wav file.wav ...] [--device cpu]

Runs the recipe behind every committed bank (``pqmf_tpu/data/hk*_finetuned
.npz``): ``parallel.training.finetune_filterbank`` with the cosine lr
schedule. Before and after, it reads the designed and the fine-tuned
bank's steady-state round-trip SNR through ``StreamingPQMF.roundtrip`` on
each ``--wav`` (multichannel files mono-averaged) or, without one, on a 60
s test signal (a 440 Hz sine at 0.5 plus seeded noise at 0.1, 44.1 kHz),
and the fine-tuned bank's worst stopband. The npz holds ``hk`` and ``h``,
the layout ``load_pretrained_bank`` reads. The M=64 bank (2048 taps)
needs the longer interior window: ``--length 16384 --steps 12000 --batch
2``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SR = 44100


def bench_signal(n: int) -> np.ndarray:
    """A 440 Hz sine at 0.5 plus ``default_rng(0)`` noise at 0.1, float32,
    at 44.1 kHz (the JAX package's ``bench.py`` signal)."""
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / SR
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n).astype(np.float32))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_band", type=int, required=True)
    p.add_argument("--attenuation", type=float, default=100.0)
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--length", type=int, default=8192)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--stopband_weight", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="npz path to write")
    p.add_argument("--wav", action="append", default=None,
                   help="wav file to read the SNRs on (repeatable; default: "
                        "a 60 s test signal)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pqmf_tpu_torch.parallel.training import (finetune_filterbank,
                                                  roundtrip_snr,
                                                  streaming_roundtrip_snr,
                                                  worst_stopband_db)

    def snrs(params):
        if not args.wav:
            return [("60 s test signal", roundtrip_snr(
                params, args.attenuation, args.n_band, bench_signal(60 * SR),
                device=args.device))]
        return [(os.path.basename(w), streaming_roundtrip_snr(
            params, args.attenuation, args.n_band, w, device=args.device))
            for w in args.wav]

    print(f"designed bank (atten={args.attenuation:g}, M={args.n_band}):")
    for name, db in snrs(None):
        print(f"  {name}: {db:.2f} dB")

    params, losses = finetune_filterbank(
        args.attenuation, args.n_band, steps=args.steps, batch=args.batch,
        length=args.length, lr=args.lr,
        stopband_weight=args.stopband_weight, seed=args.seed,
        lr_schedule="cosine", device=args.device)
    print(f"noise interior loss: {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({args.steps} steps, cosine lr peak {args.lr:g})")

    print("fine-tuned bank:")
    for name, db in snrs(params):
        print(f"  {name}: {db:.2f} dB")
    print(f"worst stopband: {worst_stopband_db(params['hk']):.1f} dB")

    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    np.savez_compressed(out, hk=params["hk"], h=params["h"])
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
