#!/usr/bin/env python3
"""Small-buffer micro-batching curve of the flagship on one card.

The port of ``tools/microbatch_curve.py``. A real-time host at a small
buffer (the reference's ``m_buffer_size`` default, 512 samples: 11.6 ms at
44.1 kHz) can queue K consecutive blocks and submit them as ONE call that
runs all K through the stateful pitch-shift step, the crossfade state
carried, so the audio equals K single calls. Here that call is
``streaming.scan_blocks`` over the wrapper's graphed ``pitchshift_fn``: one
CUDA graph of the whole K-step loop once captured. For each K the tool
takes the host's wall time of a call, up to the result on the card
(``torch.cuda.synchronize``), best of ``--reps`` after the capture, and
prints it per block against the block's audio budget, the added latency
(K blocks of buffering plus the call) and the smallest K that keeps real
time, beside ``utils.profiling.dispatch_floor_ms`` (one launch of a
one-element kernel) and the card's name and power limit. ``--cpu`` runs
the CPU port on the host clock: a check of the tool, not a measurement of
the card.

    python3 tools/gpu_microbatch_curve.py [--block 512] [--ks 1 2 4 8 16 32 64]
    python3 tools/gpu_microbatch_curve.py --cpu --ks 1 2 --reps 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SR = 44100


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--n_band", type=int, default=16)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--ks", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64])
    ap.add_argument("--cpu", action="store_true",
                    help="run the CPU port (host clock): a check of the tool")
    args = ap.parse_args()

    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper
    from pqmf_tpu_torch.streaming import scan_blocks
    from pqmf_tpu_torch.utils.profiling import dispatch_floor_ms

    if args.cpu:
        device, where, floor = "cpu", "cpu (host clock)", None
    else:
        if not torch.cuda.is_available():
            print("gpu_microbatch_curve: no CUDA device (use --cpu to check "
                  "the tool on the CPU)", file=sys.stderr)
            return 1
        from gpu_serving_scaling import card_line

        device, where, floor = "cuda", card_line(), dispatch_floor_ms()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    budget_ms = args.block / SR * 1e3
    w = PQMFPitchShiftWrapper(100, args.n_band, args.block, SR,
                              device=device)
    rng = np.random.default_rng(0)
    print(f"device {where}  block={args.block} ({budget_ms:.2f} ms audio "
          f"budget)  dispatch_floor_ms="
          f"{'n/a' if floor is None else f'{floor:.4f}'}")
    print(f"{'K':>4s} {'wall ms/call':>13s} {'ms/block':>9s} "
          f"{'budget x':>9s} {'added latency ms':>17s}  realtime?")
    rows, best_k = [], None
    for K in args.ks:
        blocks = torch.from_numpy((0.1 * rng.standard_normal(
            (K, 1, 1, args.block))).astype(np.float32)).to(w.device)
        state = w.init_state()
        for _ in range(2):  # the eager run, then the capture
            scan_blocks(w.pitchshift_fn, state, blocks)
        sync()
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            scan_blocks(w.pitchshift_fn, state, blocks)
            sync()
            best = min(best, time.perf_counter() - t0)
        wall = best * 1e3
        per_block = wall / K
        ok = per_block <= budget_ms
        latency = K * budget_ms + wall
        if ok and best_k is None:
            best_k = (K, latency)
        rows.append({"K": K, "wall_ms_per_call": wall,
                     "ms_per_block": per_block,
                     "budget_share": per_block / budget_ms,
                     "added_latency_ms": latency, "realtime": ok})
        print(f"{K:4d} {wall:13.4f} {per_block:9.4f} "
              f"{per_block / budget_ms:9.4f} {latency:17.2f}  "
              f"{'YES' if ok else 'no'}")
    if best_k:
        print(f"smallest real-time K = {best_k[0]} (added latency "
              f"~{best_k[1]:.1f} ms)")
    else:
        print("no K in range kept real time")
    print(json.dumps({"tool": "gpu_microbatch_curve", "device": where,
                      "block": args.block, "budget_ms": budget_ms,
                      "dispatch_floor_ms": floor,
                      "smallest_realtime_k": best_k[0] if best_k else None,
                      "points": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
