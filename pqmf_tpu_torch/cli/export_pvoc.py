"""Export and test of the flagship phase-vocoder pitch-shift wrapper
(reference: 1-PitchShifterWrapper.py:328-371).

    python -m pqmf_tpu_torch.cli.export_pvoc --input in.wav
        [--out_dir artifacts/pqmfpvoc] [--seed N] [--save_audio]
        [--finetuned] [--stablehlo]

Per-band shifts drawn from uniform(-24.75, 12.43), artifact save and
reload, then a whole-file forward round trip, pitchshift and decompose of
the wav padded to a buffer multiple; shapes printed. With ``--stablehlo``
the artifact also carries the ``torch.export`` program of the pitch-shift
step at one buffer.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="wav file to process")
    p.add_argument("--out_dir", default="artifacts/pqmfpvoc")
    p.add_argument("--audio_dir", default="audio")
    p.add_argument("--attenuation", type=int, default=100)
    p.add_argument("--n_band", type=int, default=16)
    p.add_argument("--buffer", type=int, default=8192)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save_audio", action="store_true",
                   help="also write the shifted audio (the reference left "
                        "this commented out, :369-371)")
    p.add_argument("--finetuned", action="store_true",
                   help="install the committed fine-tuned bank for this "
                        "(attenuation, n_band) before export")
    p.add_argument("--stablehlo", action="store_true",
                   help="also save the pitchshift method's ahead-of-time "
                        "program (a torch.export program, <method>.pt2; "
                        "the flag keeps the JAX CLI's name)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pqmf_tpu_torch.cli._common import (install_finetuned_bank,
                                            parse_shifts)
    from pqmf_tpu_torch.export import load_artifact, save_artifact
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper
    from pqmf_tpu_torch.utils.audio import read_wav, write_wav

    shifts = parse_shifts(None, args.n_band, args.seed, -24.75, 12.43)
    print(f"using shifts (semitones): {[round(s, 2) for s in shifts]}")

    wrapper = PQMFPitchShiftWrapper(args.attenuation, args.n_band,
                                    args.buffer, 44100, shifts,
                                    device=args.device)
    if args.finetuned:
        bank = install_finetuned_bank(wrapper, args.attenuation, args.n_band)
        print(f"installed fine-tuned bank {bank} (weights ride in the "
              f"artifact)")
    save_artifact(wrapper, args.out_dir, with_stablehlo=args.stablehlo)
    print(f"artifact saved to {args.out_dir}")

    loaded, _ = load_artifact(args.out_dir, device=args.device)
    print(f"reloaded: methods={loaded.get_methods()}")
    # offline whole-file pass, like the reference main feeding the whole
    # padded wav (1-PitchShifterWrapper.py:346-367); the declared
    # max_buffer_size applies to real-time host blocks
    loaded.max_buffer_size = None

    wav, sr = read_wav(args.input)
    wav = wav[:1]
    pad = (args.buffer - wav.shape[-1] % args.buffer) % args.buffer
    if pad:
        wav = np.pad(wav, ((0, 0), (0, pad)))
    wav = wav.astype(np.float32)
    print(f"audio loaded: shape={wav.shape}, sr={sr}")

    reconstructed = loaded.forward(wav)
    shifted = loaded.pitchshift(wav)
    subbands = loaded.decompose(wav)
    print(f"subbands shape: {tuple(subbands.shape)}")
    print(f"reconstructed shape: {tuple(reconstructed.shape)}")
    print(f"pitchshift output shape: {tuple(shifted.shape)}")

    if args.save_audio:
        os.makedirs(args.audio_dir, exist_ok=True)
        write_wav(os.path.join(args.audio_dir, "phasevocoder.wav"),
                  shifted.cpu().numpy(), sr)
        print("shifted audio saved")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
