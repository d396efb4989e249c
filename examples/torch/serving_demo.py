"""Serving demo of the port: the ahead-of-time artifact and S concurrent
streams on the card.

1. export the flagship pitch-shift wrapper (atten 100, 16 bands, 8192
   blocks, fixed shifts) to an artifact directory: weights, manifest and
   the ``torch.export`` program of the block step (``pitchshift.pt2``);
2. reload it both ways, as a wrapper (``load_artifact``) and as the program
   alone (``load_stablehlo``, no wrapper, no retrace), and hold the
   program's output and carried tail against the live wrapper over two
   blocks (bit-equal expected; at most 1e-6, or the demo fails);
3. serve S independent streams, each with its own crossfade tail, for N
   blocks with ``pitchshift_streams``, and time the step with
   ``utils.profiling.chained_ms`` (CUDA events on the card).

    python examples/torch/serving_demo.py [--streams 8] [--blocks 16]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile
import time

import demo_common as _common
import numpy as np

# the JAX demo's shifts, cycled to any band count
SHIFTS = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--blocks", type=int, default=16)
    p.add_argument("--buffer", type=int, default=8192)
    p.add_argument("--n_band", type=int, default=16)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    args = p.parse_args(argv)

    import torch

    from pqmf_tpu_torch.export import (load_artifact, load_stablehlo,
                                       save_artifact)
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper
    from pqmf_tpu_torch.utils.profiling import chained_ms

    print(_common.card_line(args.device))
    shifts = [SHIFTS[i % len(SHIFTS)] for i in range(args.n_band)]
    with tempfile.TemporaryDirectory() as td:
        # 1. export: weights, manifest and the program of the block step
        w = PQMFPitchShiftWrapper(100, args.n_band, args.buffer,
                                  _common.SR, shifts, device=args.device)
        t0 = time.perf_counter()
        path = save_artifact(w, os.path.join(td, "pvoc"),
                             with_stablehlo=True)
        export_s = time.perf_counter() - t0
        program_bytes = os.path.getsize(os.path.join(path, "pitchshift.pt2"))
        print(f"artifact: {sorted(os.listdir(path))}; export {export_s:.2f} "
              f"s, program {program_bytes} bytes")

        # 2. reload both ways
        loaded, manifest = load_artifact(path, device=args.device)
        print(f"reloaded wrapper: methods={loaded.get_methods()}, "
              f"shifts={manifest['config']['shifts_in_semitones'][:4]}...")
        aot = load_stablehlo(path, device=args.device)
        rng = np.random.default_rng(0)
        tail_a = tail_l = loaded.init_state()["prev_tail"]
        err = 0.0
        for _ in range(2):
            x = loaded.pqmf.as_tensor(rng.standard_normal(
                (1, args.buffer)).astype(np.float32) * 0.3)
            tail_a, y_aot = aot(tail_a, x)
            state, y_live = loaded.pitchshift_fn({"prev_tail": tail_l}, x)
            tail_l = state["prev_tail"]
            err = max(err, (y_aot - y_live).abs().max().item(),
                      (tail_a - tail_l).abs().max().item())
        print(f"AOT == live wrapper over 2 blocks: max err {err:.2e}"
              + (" (bit-equal)" if err == 0.0 else ""))
        if err > 1e-6:
            raise SystemExit(f"the reloaded program is {err:.2e} from the "
                             "live wrapper")

    # 3. S streams, each with its own crossfade tail, N blocks
    S = args.streams
    blocks = loaded.pqmf.as_tensor(np.random.default_rng(1).standard_normal(
        (args.blocks, S, args.buffer)).astype(np.float32) * 0.3)
    states, outs = loaded.init_streams(S), []
    for b in blocks:
        states, y = loaded.pitchshift_streams(states, b)
        outs.append(y)
    outs = torch.stack(outs, dim=1)  # [S, N, buffer]
    order = itertools.cycle(range(args.blocks))

    def step(tail):
        st, _ = loaded.pitchshift_streams({"prev_tail": tail},
                                          blocks[next(order)])
        return st["prev_tail"]

    ms = chained_ms(step, states["prev_tail"], n=args.blocks)
    block_s = args.buffer / _common.SR
    print(f"served {S} streams x {args.blocks} blocks "
          f"({S * args.blocks * block_s:.1f} s of audio); output "
          f"{tuple(outs.shape)}, finite: {bool(torch.isfinite(outs).all())}")
    clock = "CUDA events" if blocks.is_cuda else "host clock"
    print(f"step: {ms:.4f} ms ({clock}, chained_ms n={args.blocks}); "
          f"~{S * block_s * 1e3 / ms:,.0f}x aggregate realtime")
    return 0 if bool(torch.isfinite(outs).all()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
