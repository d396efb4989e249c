"""Fine-tune the PQMF bank past its Kaiser design, on the port.

The reference's design chain minimizes amplitude distortion over a
one-parameter Kaiser family; treating the whole modulated bank as
learnable (all M x P taps) with the interior reconstruction loss and a
stopband penalty (``parallel.training.make_finetune_loss``) finds banks
that family cannot express. The demo prints the designed bank's
steady-state round-trip SNR, fine-tunes, and prints the trained bank's
(``parallel.training.roundtrip_snr``, through ``StreamingPQMF.roundtrip``).

    python examples/torch/finetune_demo.py --steps 200        # quick look
    python examples/torch/finetune_demo.py --steps 8000 --lr 2e-5 \\
        --lr_schedule cosine --batch 4 --length 8192  # the committed recipe

Without ``--wav`` the SNR is read on bench.py's 60 s test signal.
"""

from __future__ import annotations

import argparse

import demo_common as _common
import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n_band", type=int, default=16)
    ap.add_argument("--atten", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-6)
    ap.add_argument("--lr_schedule", choices=["constant", "cosine"],
                    default="constant",
                    help="cosine (lr as the peak, decayed to 0); every "
                         "committed bank uses it")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--length", type=int, default=4096)
    ap.add_argument("--stopband_weight", type=float, default=1e-4)
    ap.add_argument("--wav", default=None,
                    help="wav to read the SNR on (default: bench.py's "
                         "test signal)")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", default=None,
                    help="save the fine-tuned bank as an .npz")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)

    from pqmf_tpu_torch.parallel.training import (finetune_filterbank,
                                                  roundtrip_snr)

    x, _ = _common.load_input(args.wav, args.seconds)
    x = x.mean(axis=0)
    M = args.n_band
    print(_common.card_line(args.device))
    before = roundtrip_snr(None, args.atten, M, x, device=args.device)
    print(f"designed bank   : {before:6.2f} dB round-trip SNR")
    print(f"fine-tuning {args.steps} steps (Adam {args.lr} "
          f"{args.lr_schedule}, stopband weight {args.stopband_weight}) ...")
    params, losses = finetune_filterbank(
        args.atten, M, steps=args.steps, lr=args.lr, batch=args.batch,
        length=args.length, stopband_weight=args.stopband_weight,
        lr_schedule=args.lr_schedule, device=args.device)
    print(f"interior loss   : {losses[0]:.3e} -> {losses[-1]:.3e}")
    after = roundtrip_snr(params, args.atten, M, x, device=args.device)
    print(f"fine-tuned bank : {after:6.2f} dB round-trip SNR")
    if args.out:
        np.savez_compressed(args.out, hk=np.asarray(params["hk"]),
                            h=np.asarray(params["h"]))
        print(f"saved -> {args.out}")
    return 0 if np.isfinite(losses).all() and np.isfinite(after) else 1


if __name__ == "__main__":
    raise SystemExit(main())
