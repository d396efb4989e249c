"""Export and round-trip test of the plain PQMF wrapper
(reference: PQMFWrapper.py:96-135).

    python -m pqmf_tpu_torch.cli.export_pqmf --input in.wav [--stablehlo]

Builds PQMFWrapper(atten=100, n_band=16, buffer=8192), optionally installs
the committed fine-tuned bank, saves the artifact (with ``--stablehlo``
the ``torch.export`` program of ``process`` at one buffer too), reloads
it, runs forward/inverse/process on the wav padded to a buffer multiple,
and writes ``reconstruido.wav``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="wav file to round-trip")
    p.add_argument("--out_dir", default="artifacts/pqmf")
    p.add_argument("--audio_dir", default="audio")
    p.add_argument("--attenuation", type=int, default=100)
    p.add_argument("--n_band", type=int, default=16)
    p.add_argument("--buffer", type=int, default=8192)
    p.add_argument("--finetuned", action="store_true",
                   help="install the committed fine-tuned bank for this "
                        "(attenuation, n_band) before export (see "
                        "parallel.training.load_pretrained_bank)")
    p.add_argument("--stablehlo", action="store_true",
                   help="also save the process method's ahead-of-time "
                        "program (a torch.export program, <method>.pt2; "
                        "the flag keeps the JAX CLI's name)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pqmf_tpu_torch.export import load_artifact, save_artifact
    from pqmf_tpu_torch.pipelines import PQMFWrapper
    from pqmf_tpu_torch.utils.audio import read_wav, write_wav

    print("exporting PQMFWrapper artifact...")
    wrapper = PQMFWrapper(args.attenuation, args.n_band,
                          m_buffer_size=args.buffer, device=args.device)
    if args.finetuned:
        from pqmf_tpu_torch.parallel.training import load_pretrained_bank

        name = f"hk{args.n_band}_atten{args.attenuation}_finetuned"
        wrapper.pqmf.set_weights(load_pretrained_bank(name))
        print(f"installed fine-tuned bank {name} (weights ride in the "
              f"artifact)")
    save_artifact(wrapper, args.out_dir, with_stablehlo=args.stablehlo)
    print(f"artifact saved to {args.out_dir}")

    loaded, _ = load_artifact(args.out_dir, device=args.device)
    print(f"reloaded: methods={loaded.get_methods()}")
    # offline whole-file pass (the reference main feeds the whole padded
    # wav through the wrapper too, PQMFWrapper.py:112-131); the declared
    # max_buffer_size applies to real-time host blocks
    loaded.max_buffer_size = None

    wav, sr = read_wav(args.input)
    wav = wav[:1]
    buffer_size = loaded.m_buffer_size
    pad = (buffer_size - wav.shape[-1] % buffer_size) % buffer_size
    if pad:
        wav = np.pad(wav, ((0, 0), (0, pad)))
    print(f"audio loaded: shape={wav.shape}, sr={sr}")

    subbands = loaded.forward(wav)
    reconstructed = loaded.inverse(subbands)
    recon, sub = loaded.process(wav)
    print(f"subbands shape: {tuple(subbands.shape)}")
    print(f"reconstructed shape: {tuple(reconstructed.shape)}")
    print(f"process output shapes: "
          f"{[tuple(t.shape) for t in (recon, sub)]}")

    os.makedirs(args.audio_dir, exist_ok=True)
    out_path = os.path.join(args.audio_dir, "reconstruido.wav")
    write_wav(out_path, reconstructed[0].cpu().numpy(), sr)
    print(f"reconstructed audio saved to {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
