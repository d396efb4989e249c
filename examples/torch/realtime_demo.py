"""End-to-end demo of the port: three ways to run the flagship pitch
shifter.

    python examples/torch/realtime_demo.py [input.wav] [--device cuda]

1. Block by block (a real-time host's call pattern; explicit state).
2. The block-streaming harness ``stream_ola`` over the whole signal
   (windowed blocks, half overlap, the crossfade state carried).
3. One step of 16 independent streams (``pitchshift_streams``).

Without an input it runs bench.py's test signal (``--seconds``).
"""

from __future__ import annotations

import argparse
import time

import demo_common as _common
import numpy as np

SHIFTS = [0, 2, -2, 4, -4, 5, -5, 7, -7, 9, -9, 12, -12, 3, -3, 0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", nargs="?", default=None,
                   help="wav file (default: bench.py's test signal)")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--buffer", type=int, default=8192)
    p.add_argument("--n_band", type=int, default=16)
    p.add_argument("--out", default=None, help="write the shifted wav here")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    args = p.parse_args(argv)

    import torch

    from pqmf_tpu_torch import PQMFPitchShiftWrapper, stream_ola
    from pqmf_tpu_torch.utils.audio import rms, write_wav

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    x, sr = _common.load_input(args.input, args.seconds)
    buffer = args.buffer
    x = np.pad(x, ((0, 0), (0, (-x.shape[-1]) % buffer)))
    print(f"{args.input or 'bench.py signal'}: {x.shape[-1] / sr:.1f} s at "
          f"{sr} Hz; {_common.card_line(args.device)}")
    shifts = [SHIFTS[i % len(SHIFTS)] for i in range(args.n_band)]
    w = PQMFPitchShiftWrapper(100, args.n_band, buffer, sr, shifts,
                              device=args.device)

    # 1. real-time host pattern: one block per call, carried state
    state = w.init_state()
    sync()
    t0 = time.perf_counter()
    outs = []
    for i in range(0, x.shape[-1], buffer):
        state, y = w.pitchshift_fn(state, x[:, i:i + buffer])
        outs.append(y)
    host_loop = torch.cat(outs, dim=-1)
    sync()
    print(f"1. block loop: {time.perf_counter() - t0:.3f} s for "
          f"{len(outs)} blocks (first use included), rms "
          f"{rms(host_loop.cpu().numpy()):.4f}")

    # 2. the whole signal through the block-streaming harness
    t0 = time.perf_counter()
    pitch, recon = stream_ola(w, x, block=buffer, overlap=buffer // 2)
    sync()
    print(f"2. stream_ola: {time.perf_counter() - t0:.3f} s, pitch rms "
          f"{rms(pitch.cpu().numpy()):.4f}, recon rms "
          f"{rms(recon.cpu().numpy()):.4f} (input {rms(x):.4f})")

    # 3. multi-stream serving: 16 copies as independent streams
    S = 16
    block = np.repeat(x[:, :buffer], S, axis=0)
    t0 = time.perf_counter()
    _, ys = w.pitchshift_streams(w.init_streams(S), block)
    sync()
    print(f"3. {S}-stream step: {time.perf_counter() - t0:.3f} s, out "
          f"{tuple(ys.shape)}")

    if args.out:
        write_wav(args.out, host_loop.cpu().numpy(), sr)
        print(f"wrote {args.out}")
    ok = all(bool(torch.isfinite(t).all()) for t in (host_loop, pitch, ys))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
