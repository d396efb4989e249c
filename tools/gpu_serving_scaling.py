#!/usr/bin/env python3
"""Serving capacity of one card: aggregate throughput of the flagship's
graphed multi-stream pitch-shift step against the number of streams.

The port of ``tools/serving_scaling.py``. For S in ``--streams`` it builds
``PQMFPitchShiftWrapper(100, 16, 8192)`` on the card, and times
``pitchshift_streams`` (one CUDA graph a step once captured) over S
independent streams of 8192-sample blocks with
``utils.profiling.chained_ms``: chains of n and 2n steps, the crossfade
state carried from step to step, differenced, so the launch of the first
step and the final synchronize cancel. A point whose step would not fit in
the card's free memory (estimated from the smallest S's graph pool, scaled
by S) is skipped and said so. Prints, per S, ms a step, the per-stream
real-time factor (audio seconds a step over step seconds) and the
aggregate (S times it), then the largest S whose streams each stay at or
above real time, and one JSON line of every point. Times are on the card's
clock (CUDA events), beside its name and power limit; with ``--cpu`` the
same sweep runs on the CPU port on the host clock (a check of the tool,
not a measurement of the card).

    python3 tools/gpu_serving_scaling.py [--streams 1,4,16,64,128,256] \
        [--n_blocks 32] [--precision highest]
    python3 tools/gpu_serving_scaling.py --cpu --streams 1,2 --n_blocks 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SR = 44100
BLOCK = 8192


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure(n_streams: int, n_blocks: int, precision: str, device) -> dict:
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper
    from pqmf_tpu_torch.utils.profiling import chained_ms

    w = PQMFPitchShiftWrapper(100, 16, BLOCK, SR, precision=precision,
                              device=device)
    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        (n_streams, BLOCK))).astype(np.float32)).to(w.device)

    def step(tail):
        return w.pitchshift_streams({"prev_tail": tail}, x)[0]["prev_tail"]

    tail = w.init_streams(n_streams)["prev_tail"]
    step(step(tail))  # the eager run, then the capture
    ms = chained_ms(step, tail, n=n_blocks)
    prog = next(iter(w._graphs.values()), None)
    pool = prog.stats["pool_bytes"] if prog and prog.stats else None
    per_stream = (BLOCK / SR) / (ms / 1e3)
    return {"streams": n_streams, "ms_per_step": ms,
            "per_stream_rtf": per_stream,
            "aggregate_rtf": n_streams * per_stream,
            "realtime": bool(per_stream >= 1.0), "graph_pool_bytes": pool}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", default="1,4,16,64,128,256")
    ap.add_argument("--n_blocks", type=int, default=32,
                    help="steps in the shorter chain (the longer has 2x)")
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--cpu", action="store_true",
                    help="run the CPU port (host clock): a check of the tool")
    args = ap.parse_args()
    if args.cpu:
        device, where = "cpu", "cpu (host clock; not a card measurement)"
    else:
        if not torch.cuda.is_available():
            print("gpu_serving_scaling: no CUDA device (use --cpu to check "
                  "the tool on the CPU)", file=sys.stderr)
            return 1
        device = "cuda"
        where = f"{card_line()} (CUDA events)"
    print(f"device {where}  block={BLOCK}  precision={args.precision}  "
          f"n_blocks={args.n_blocks}")
    print(f"{'S':>4} {'ms/step':>10} {'per-stream RTF':>15} "
          f"{'aggregate RTF':>14} {'realtime?':>9}")
    rows, per_stream_bytes = [], None
    for s in (int(v) for v in args.streams.split(",")):
        if device == "cuda" and per_stream_bytes:
            free, _ = torch.cuda.mem_get_info()
            need = 2 * s * per_stream_bytes
            if need > free:
                print(f"{s:>4} skipped: needs ~{need / 2**30:.1f} GiB, "
                      f"{free / 2**30:.1f} GiB free")
                continue
        row = measure(s, args.n_blocks, args.precision, device)
        if row["graph_pool_bytes"] and per_stream_bytes is None:
            per_stream_bytes = row["graph_pool_bytes"] / s
        rows.append(row)
        print(f"{s:>4} {row['ms_per_step']:>10.4f} "
              f"{row['per_stream_rtf']:>15,.1f} "
              f"{row['aggregate_rtf']:>14,.1f} "
              f"{'yes' if row['realtime'] else 'NO':>9}")
        if device == "cuda":
            torch.cuda.empty_cache()
    ok = [r["streams"] for r in rows if r["realtime"]]
    best = max(rows, key=lambda r: r["aggregate_rtf"]) if rows else None
    print(f"largest real-time S: {max(ok) if ok else None}; peak aggregate "
          f"RTF {best['aggregate_rtf']:,.1f} at S={best['streams']}"
          if best else "no point measured")
    print(json.dumps({"tool": "gpu_serving_scaling", "device": where,
                      "block": BLOCK, "precision": args.precision,
                      "largest_realtime_streams": max(ok) if ok else None,
                      "points": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
