"""Standalone phase-vocoder pitch-shift CLI
(reference: VocoderPitchShifter.py:350-383).

    python -m pqmf_tpu_torch.cli.vocoder in.wav out.wav --n_steps 4
        [--n_fft 1024 --hop_length 256 --win_length 1024] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Phase-vocoder pitch shifter test CLI")
    p.add_argument("input", help="input wav")
    p.add_argument("output", help="output wav")
    p.add_argument("--n_steps", type=float, default=4.0, help="semitones")
    p.add_argument("--n_fft", type=int, default=1024)
    p.add_argument("--hop_length", type=int, default=256)
    p.add_argument("--win_length", type=int, default=1024)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from pqmf_tpu_torch.shifters import PhaseVocoderPitchShift
    from pqmf_tpu_torch.streaming import resolve_device
    from pqmf_tpu_torch.utils.audio import read_wav, write_wav

    dev = resolve_device(args.device)
    x, sr = read_wav(args.input)
    if x.shape[0] > 1:
        x = x.mean(axis=0, keepdims=True)  # mono mixdown like the reference
    print(f"loaded {args.input}: {x.shape}, sr={sr}")

    sh = PhaseVocoderPitchShift(n_fft=args.n_fft, hop_length=args.hop_length,
                                win_length=args.win_length)
    y = sh(torch.tensor(x.astype(np.float32), device=dev),
           int(round(args.n_steps))).cpu().numpy()

    maxv = float(np.max(np.abs(y)))
    if maxv > 1.0:  # avoid PCM16 clipping (reference :374-377)
        y = y / maxv
    write_wav(args.output, y, sr)
    print(f"saved {args.output}: {y.shape}, sr={sr}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
