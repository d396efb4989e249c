#!/usr/bin/env python3
"""Device times of the tier kernels of two checkouts of the port, on one card.

    python3 tools/tier_ab.py OTHER_CHECKOUT [--rounds 2]

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``. Each round times, in a fresh process per checkout (this one and
OTHER_CHECKOUT, in the order other, this, this, other), the device time
(``torch.profiler``, all kernels of a call) of K1t and K2t at the flagship's
block shapes ([1,1,8704] / [16,1,8704] analysis, [1,16,544] / [16,16,544]
synthesis), of K4t / K5t (``polyphase_analysis`` / ``_synthesis``) on
60 s, and of K3t (``fused_roundtrip_conv``) at [1,1,8704] and on 60 s
(pre-padded inputs), with K6t (``polyphase_roundtrip``) and
``StreamingPQMF.roundtrip`` on 60 s (each checkout's own route, its pad
and slice copies included), at "bf16x3" and "default", through each
checkout's public wrappers on the same seeded inputs; and, at "highest",
K2 where it takes a pad (``StreamingPQMF.inverse`` of one block's
sub-bands, K5 on 60 s). Where a checkout's wrappers take kept arranged
banks (``bank=`` / ``tc_bank=`` / ``banks=``), they are built once
beforehand, as the entry points build them when weights are installed.
Prints the card's name and power limit, then one JSON line per checkout
and round.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure() -> dict:
    """The device times (us per call) of the checkout on sys.path[0]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    pq = StreamingPQMF(100, 16, device="cpu")
    wa, ws = pq.hkf.to(dev), pq.hki.to(dev)
    off = PQMF(100, 16, device="cpu")
    hp, hi = (off.params[k].to(dev) for k in ("hk_poly", "hk_ipoly"))
    w2 = pk.analysis_weights(hp)
    kept = "bank" in inspect.signature(cc.strided_analysis_conv).parameters
    rt_kept = "banks" in inspect.signature(cc.fused_roundtrip_conv).parameters
    xs = {"K1t [1,1,8704]": torch.randn(1, 1, 8704, generator=g),
          "K1t [16,1,8704]": torch.randn(16, 1, 8704, generator=g),
          "K2t [1,16,544]": torch.randn(1, 16, 544, generator=g),
          "K2t [16,16,544]": torch.randn(16, 16, 544, generator=g),
          "K4t 60 s": torch.randn(1, 1, 60 * 44100, generator=g),
          "K5t 60 s": torch.randn(1, 16, 60 * 44100 // 16, generator=g),
          "K3t [1,1,8704]": torch.randn(1, 1, 8704, generator=g),
          "K3t 60 s": torch.randn(1, 1, 60 * 44100 + 512, generator=g),
          "K6t 60 s": torch.randn(1, 1, 60 * 44100, generator=g)}
    xs = {k: v.to(dev) for k, v in xs.items()}
    sub = torch.randn(1, 16, 512, generator=g).to(dev)
    sp = StreamingPQMF(100, 16, device="cuda")

    def device_us(fn, n):
        for _ in range(3):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            total = sum(getattr(e, "self_device_time_total", 0.0)
                        for e in prof.key_averages()
                        if getattr(e, "device_type", None) == DeviceType.CUDA)
            if total > 0:
                return total / n
        raise RuntimeError("torch.profiler recorded no device time")

    out = {}
    for tier in ("bf16x3", "default"):
        kw = {}
        if kept:
            kw = {k: cc.arrange_tc_bank(w, kind, tier) for k, w, kind in [
                ("wa", wa, "analysis"), ("ws", ws, "synthesis"),
                ("w2", w2, "analysis"), ("hi", hi, "synthesis")]}
        calls = {
            "K1t": lambda x: cc.strided_analysis_conv(
                x, wa, 16, precision=tier,
                **({"bank": kw["wa"]} if kept else {})),
            "K2t": lambda x: cc.dense_synthesis_conv(
                x, ws, True, -16, tier,
                **({"bank": kw["ws"]} if kept else {})),
            "K4t": lambda x: pk.polyphase_analysis(
                x, hp, w2, tier, *([kw["w2"]] if kept else [])),
            "K5t": lambda x: pk.polyphase_synthesis(
                x, hi, tier, *([kw["hi"]] if kept else [])),
            "K3t": lambda x: cc.fused_roundtrip_conv(
                x, wa, ws, 16, (16, 16), tier,
                **({"banks": (kw["wa"], kw["ws"])} if rt_kept else {})),
            "K6t": lambda x: pk.polyphase_roundtrip(
                x, hp, hi, w2, tier,
                *([(kw["w2"], kw["hi"])] if rt_kept else [])),
        }
        for what, x in xs.items():
            fn = calls[what[:3]]
            out[f"{what} {tier}"] = device_us(
                lambda: fn(x), 10 if "60 s" in what else 50)
        # the streaming round trip as its entry point runs it
        spt = StreamingPQMF(100, 16, precision=tier, device="cuda")
        out[f"StreamingPQMF.roundtrip 60 s {tier}"] = device_us(
            lambda: spt.roundtrip(xs["K6t 60 s"]), 10)
    # K2's pad at "highest": the flagship's synthesis of one block and K5
    # on 60 s (a checkout that pads before K2 launches that copy too)
    out["StreamingPQMF.inverse [1,16,512] highest"] = device_us(
        lambda: sp.inverse(sub), 50)
    out["K5 60 s highest"] = device_us(
        lambda: pk.polyphase_synthesis(xs["K5t 60 s"], hi), 10)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.measure:  # the child: this process times the checkout it runs in
        sys.path.insert(0, os.getcwd())
        print(json.dumps(measure()))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    other = Path(args.other).resolve()
    for r in range(args.rounds):
        for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                           ("other", other)):
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(root),
                 "--measure"], cwd=root, capture_output=True, text=True,
                timeout=900)
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            print(json.dumps({"checkout": name, "root": str(root),
                              "round": r,
                              "device_us": json.loads(
                                  res.stdout.strip().splitlines()[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
