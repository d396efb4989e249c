"""Torchaudio-variant per-band pitch-shift test main
(reference: PitchShifterTorchaudio/PQMFPsWrapper.py:154-197).

    python -m pqmf_tpu_torch.cli.ps_torchaudio in.wav [--n_band 16]
        [--buffer 8192] [--shifts s0,s1,...] [--seed N] [--out_dir audio]
        [--finetuned] [--device cpu]

Builds the torchaudio-variant wrapper (one accumulating phase-vocoder +
windowed-sinc-resample shifter per band at the sub-band sample rate
``round(sr / n_band)``), runs forward / inverse / pitchshifter on the wav
padded to a buffer multiple, writes ``reconstruido.wav`` and
``ta_pitchshifted.wav``, and prints the shapes and RMS.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help="input wav")
    p.add_argument("--attenuation", type=int, default=100)
    p.add_argument("--n_band", type=int, default=16)
    p.add_argument("--buffer", type=int, default=8192)
    p.add_argument("--sample_rate", type=int, default=None)
    p.add_argument("--shifts", type=str, default=None,
                   help="comma-separated semitones per band; default "
                        "uniform(-48.53, 12.32) draws like the reference "
                        "(PQMFPsWrapper.py:157)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="audio")
    p.add_argument("--finetuned", action="store_true",
                   help="install the committed fine-tuned bank for this "
                        "(attenuation, n_band)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pqmf_tpu_torch.cli._common import (install_finetuned_bank,
                                            parse_shifts)
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapperTA
    from pqmf_tpu_torch.utils.audio import read_wav, rms, write_wav

    wav, sr = read_wav(args.input)
    if wav.shape[0] > 1:
        wav = wav.mean(axis=0, keepdims=True)
    wav = wav.astype(np.float32)
    if args.sample_rate:
        sr = args.sample_rate

    shifts = parse_shifts(args.shifts, args.n_band, args.seed, -48.53, 12.32)
    print(f"shifts (semitones): {[round(s, 2) for s in shifts]}")

    pad = (-wav.shape[-1]) % args.buffer
    wav = np.pad(wav, ((0, 0), (0, pad)))
    print(f"loaded {args.input}: shape={wav.shape}, sr={sr}, pad={pad}")

    # max_buffer_size=None: the whole padded file goes in one call, like
    # the reference main (PQMFPsWrapper.py:177)
    w = PQMFPitchShiftWrapperTA(args.attenuation, args.n_band, args.buffer,
                                sr, shifts, max_buffer_size=None,
                                device=args.device)
    if args.finetuned:
        print(f"installed fine-tuned bank "
              f"{install_finetuned_bank(w, args.attenuation, args.n_band)}")
    x = wav[None]
    sub = w.forward(x)
    recon = w.inverse(sub).cpu().numpy()
    shifted = w.pitchshifter(x).cpu().numpy()
    print(f"subbands: {tuple(sub.shape)}, reconstructed: {recon.shape}, "
          f"pitchshifted: {shifted.shape}")

    os.makedirs(args.out_dir, exist_ok=True)
    write_wav(os.path.join(args.out_dir, "reconstruido.wav"), recon[0], sr)
    write_wav(os.path.join(args.out_dir, "ta_pitchshifted.wav"),
              shifted[0], sr)
    print("RMS orig:", rms(wav))
    print("RMS recon:", rms(recon))
    print("RMS shifted:", rms(shifted))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
