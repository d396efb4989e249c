"""Block-streaming test harness (reference: 2-TestBlocks.py:20-166).

Simulates a real-time host: Hann-windowed overlapping blocks -> the
per-block stateful pitch shift, crossfade state carried -> windowed
overlap-add normalized by the accumulated window energy, beside a plain
round-trip stream and a whole-file pass, with RMS printed at the end (the
reference's only quantitative output). The whole-file pass calls the
method that exists (the reference's calls a missing one, SURVEY.md
§2.5-2), so ``nonblock_pitchshifter.wav`` is written.

    python -m pqmf_tpu_torch.cli.blocks in.wav --block 4096 [--overlap N]
        [--out_prefix blocktest] [--out_dir DIR] [--n_band 16]
        [--buffer 8192] [--shifts s0,s1,...] [--seed N] [--artifact DIR]
        [--scan] [--stereo] [--finetuned] [--device cpu]

The host loop overlap-adds in the port's native C library
(``pqmf_tpu_torch.native``, NumPy when no C compiler is available: the
same bits); ``--scan`` runs the whole stream through
:func:`~pqmf_tpu_torch.pipelines.stream_ola` on the device instead.
``--stereo`` keeps all channels, one serving stream per channel with its
own crossfade state (the reference mixes down).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help="input wav file")
    p.add_argument("--block", type=int, default=4096,
                   help="block size (the host's buffer)")
    p.add_argument("--overlap", type=int, default=None,
                   help="overlap samples between blocks (default block//2)")
    p.add_argument("--out_prefix", type=str, default="blocktest")
    p.add_argument("--out_dir", type=str, default="audio")
    p.add_argument("--attenuation", type=int, default=100)
    p.add_argument("--n_band", type=int, default=16)
    p.add_argument("--buffer", type=int, default=8192,
                   help="m_buffer_size the wrapper is built with")
    p.add_argument("--shifts", type=str, default=None,
                   help="comma-separated semitone shifts per band; default "
                        "uniform(-24.75, 12.43) draws like the reference "
                        "export (1-PitchShifterWrapper.py:331)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--artifact", type=str, default=None,
                   help="load the wrapper from an exported artifact dir "
                        "(the reference's --ts flag, 2-TestBlocks.py:44) "
                        "instead of constructing one")
    p.add_argument("--scan", action="store_true",
                   help="run the whole stream through stream_ola on the "
                        "device (blocking and OLA there, no per-block copy "
                        "to the host)")
    p.add_argument("--finetuned", action="store_true",
                   help="install the committed fine-tuned bank for this "
                        "(attenuation, n_band) on the constructed wrapper "
                        "(ignored with --artifact: its weights ride in it)")
    p.add_argument("--stereo", action="store_true",
                   help="keep all channels, one serving stream per channel "
                        "(independent crossfade state each) instead of the "
                        "reference's mono mixdown")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pqmf_tpu_torch.cli._common import (install_finetuned_bank,
                                            parse_shifts)
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper, stream_ola
    from pqmf_tpu_torch.utils.audio import read_wav, rms, write_wav

    wav, sr = read_wav(args.input)
    if wav.shape[0] > 1 and not args.stereo:
        wav = wav.mean(axis=0, keepdims=True)
    wav = wav.astype(np.float32)
    n_ch = wav.shape[0]

    overlap = args.overlap if args.overlap is not None else args.block // 2
    if overlap < 0 or overlap >= args.block:
        raise ValueError("overlap must be in [0, block-1]")
    hop = args.block - overlap

    wrapper = None
    if args.artifact is not None:
        from pqmf_tpu_torch.export import load_artifact

        wrapper, manifest = load_artifact(args.artifact, device=args.device)
        wrapper.reset()
        shifts = list(wrapper.shifts)
        args.n_band = wrapper.n_band
        print(f"loaded artifact {args.artifact} "
              f"(kind={manifest['kind']}, n_band={wrapper.n_band})")
    else:
        shifts = parse_shifts(args.shifts, args.n_band, args.seed, -24.75,
                              12.43)
    print(f"shifts (semitones): {[round(s, 2) for s in shifts]}")

    L = wav.shape[-1]
    n_frames = 1 if L <= args.block else -(-(L - args.block) // hop) + 1
    pad = (n_frames - 1) * hop + args.block - L
    if pad > 0:
        wav = np.pad(wav, ((0, 0), (0, pad)))
    total_len = wav.shape[-1]
    print(f"loaded {args.input}: shape={wav.shape}, sr={sr}, pad={pad}, "
          f"blocks={n_frames}")

    if wrapper is None:
        wrapper = PQMFPitchShiftWrapper(args.attenuation, args.n_band,
                                        args.buffer, sr, shifts,
                                        device=args.device)
        if args.finetuned:
            name = install_finetuned_bank(wrapper, args.attenuation,
                                          args.n_band)
            print(f"installed fine-tuned bank {name}")

    if args.scan:
        t0 = time.perf_counter()
        pitch, recon = stream_ola(wrapper, wav, args.block, overlap)
        pitch_stream = pitch.cpu().numpy()[:, : total_len - pad]
        recon_stream = recon.cpu().numpy()[:, : total_len - pad]
        print(f"stream_ola: {time.perf_counter() - t0:.2f} s")
    else:
        from pqmf_tpu_torch import native

        n = np.arange(args.block)
        window = (0.5 - 0.5 * np.cos(2 * np.pi * n / args.block)).astype(
            np.float32)[None, :]
        out_accum = np.zeros((n_ch, total_len), np.float32)
        norm_accum = np.zeros_like(out_accum)
        recon_accum = np.zeros_like(out_accum)
        recon_norm = np.zeros_like(out_accum)
        nat = native.get()  # the C accumulator; None -> NumPy

        def ola(acc, nrm, blk, i):
            if nat is not None:
                for c in range(acc.shape[0]):
                    nat.ola_accumulate(acc[c], nrm[c], blk[c], window[0], i)
            else:
                acc[:, i:i + args.block] += blk * window
                nrm[:, i:i + args.block] += window * window

        # mono: the reference's single-stream stateful step; --stereo: one
        # serving stream per channel, each with its own crossfade state
        if n_ch == 1:
            state, step = wrapper.init_state(), wrapper.pitchshift_fn
        else:
            state, step = (wrapper.init_streams(n_ch),
                           wrapper.pitchshift_streams)
        for frame_idx in range(n_frames):
            i = frame_idx * hop
            blk = wav[:, i:i + args.block] * window
            state, out = step(state, blk)
            ola(out_accum, norm_accum, out.cpu().numpy(), i)
            rec = wrapper.forward_fn(blk[:, None, :])
            ola(recon_accum, recon_norm, rec.cpu().numpy(), i)
        eps = 1e-8
        pitch_stream = (out_accum / (norm_accum + eps))[:, : total_len - pad]
        recon_stream = (recon_accum / (recon_norm + eps))[:, : total_len - pad]

    # whole-file pass with the real-time buffer limit lifted; several
    # channels ride the batch axis, where (as in the reference, batch==1
    # guard at 1-PitchShifterWrapper.py:262) no crossfade runs
    wrapper.reset()
    wrapper.max_buffer_size = None
    T_full = (wav.shape[-1] // args.n_band) * args.n_band
    full_in = wav[:, :T_full] if n_ch == 1 else wav[:, None, :T_full]
    full_out = wrapper.pitchshift(full_in).cpu().numpy()[
        :, : wav.shape[-1] - pad]

    # an out_prefix with a directory part routes every output there
    if os.path.dirname(args.out_prefix):
        args.out_dir = os.path.dirname(args.out_prefix)
        args.out_prefix = os.path.basename(args.out_prefix)
    os.makedirs(args.out_dir, exist_ok=True)
    write_wav(os.path.join(args.out_dir,
                           f"{args.out_prefix}_pitchshifter.wav"),
              pitch_stream, sr)
    write_wav(os.path.join(args.out_dir,
                           f"{args.out_prefix}_recontructed.wav"),
              recon_stream, sr)
    write_wav(os.path.join(args.out_dir, "nonblock_pitchshifter.wav"),
              full_out, sr)
    print(f"saved stream + full outputs to {args.out_dir}/")

    orig = wav[:, : wav.shape[-1] - pad]
    print("RMS orig:", rms(orig))
    print("RMS stream_pitch:", rms(pitch_stream))
    print("RMS stream_recon:", rms(recon_stream))
    print("RMS full_pitch:", rms(full_out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
