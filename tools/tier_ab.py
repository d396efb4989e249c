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

    python3 tools/tier_ab.py OTHER_CHECKOUT --what flagship

times instead the live flagship block (``PQMFPitchShiftWrapper``, atten
100, 16 bands, 8192 samples, the smoke's shifts, state carried) at each
tier: ms a block by CUDA events over 200 blocks (best of 3 windows) and
the host clock's median over 200 synchronized blocks — the host-bound
step, where a change to the Python around the kernels (the operator
dispatch, for one) shows; and, since those move by tenths of a ms between
processes, the host's cost of the step's two conv calls alone
(``StreamingPQMF.forward`` of one block and ``inverse`` of its sub-bands,
K1 + K2) in us: 2000 pairs enqueued back to back, best of 5 windows. In a
checkout whose kernels are operators, the pair four times more in the
same process with the dispatcher bypassed (the impls called straight from
the wrappers) and through the operators, in turn: the dispatch's cost is
the gap between the two routes, beside the spread of each; and the host's
cost of the operators' operand checks alone.

    python3 tools/tier_ab.py OTHER_CHECKOUT --what bands

times the fused round trip at M = 32 and 64 (the designed banks, syn_pad
(16, 16)) at each tier, ``fused_roundtrip_conv`` with the kept arranged
banks at the tiers: device time (each checkout's ``chip_smoke._device_us``:
the median whole call of a profiler trace) at host blocks [1,1,8192+Ka-1]
and [16,1,8192+Ka-1] and on 60 s (the centered analysis pad in the
kernel), and CUDA events a call on 60 s; beside them the two halves
(``strided_analysis_conv`` + ``dense_synthesis_conv``) on the same input.
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


def _tier(fn, tier: str) -> dict:
    """The tier as the keyword ``fn`` takes it: ``mxu_precision`` (the JAX
    package's name) in a checkout whose kernel wrappers take it, else
    ``precision``."""
    name = ("mxu_precision" if "mxu_precision"
            in inspect.signature(fn).parameters else "precision")
    return {name: tier}


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
        k1_tier = _tier(cc.strided_analysis_conv, tier)
        k4_tier = _tier(pk.polyphase_analysis, tier)
        calls = {
            "K1t": lambda x: cc.strided_analysis_conv(
                x, wa, 16, **k1_tier,
                **({"bank": kw["wa"]} if kept else {})),
            "K2t": lambda x: cc.dense_synthesis_conv(
                x, ws, True, -16, tier,
                **({"bank": kw["ws"]} if kept else {})),
            "K4t": lambda x: pk.polyphase_analysis(
                x, hp, w2, **k4_tier,
                **({"tc_bank": kw["w2"]} if kept else {})),
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


def measure_bands() -> dict:
    """K3/K3t at M = 32 and 64 and their halves, of the checkout on
    sys.path[0]: device us at host blocks and on 60 s, events ms on 60 s."""
    import torch

    import chip_smoke
    from pqmf_tpu_torch import StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x60 = torch.randn(1, 1, 60 * 44100, generator=g).to(dev)

    def events_ms(fn, n=20):
        best = float("inf")
        for _ in range(3):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / n)
        return best

    out = {}
    for M in (32, 64):
        sp = StreamingPQMF(100, M, device="cpu")
        wa, ws = sp.hkf.to(dev), sp.hki.to(dev)
        ka = wa.shape[-1]
        xs = {"[1,1,block]": (torch.randn(1, 1, 8192 + ka - 1,
                                          generator=g).to(dev), (0, 0)),
              "[16,1,block]": (torch.randn(16, 1, 8192 + ka - 1,
                                           generator=g).to(dev), (0, 0)),
              "60 s": (x60, (ka // 2, ka // 2))}
        for tier in ("highest", "bf16x3", "default"):
            kb = None if tier == "highest" else (
                cc.arrange_tc_bank(wa, "analysis", tier),
                cc.arrange_tc_bank(ws, "synthesis", tier))

            def k3(x, pad, tier=tier, kb=kb):
                return cc.fused_roundtrip_conv(x, wa, ws, M, (16, 16), tier,
                                               pad, kb)

            def halves(x, pad, tier=tier, kb=kb):
                sub = cc.strided_analysis_conv(
                    x, wa, M, pad=pad,
                    **_tier(cc.strided_analysis_conv, tier),
                    bank=None if kb is None else kb[0])
                return cc.dense_synthesis_conv(
                    sub, ws, True, 0, tier, (16, 16),
                    None if kb is None else kb[1])

            for shape, (x, pad) in xs.items():
                n = 10 if shape == "60 s" else 50
                for name, fn in (("K3", k3), ("halves", halves)):
                    key = f"{name} M={M} {shape} {tier}"
                    out[key + " device_us"] = chip_smoke._device_us(
                        lambda: fn(x, pad), n)
                    if shape == "60 s":
                        out[key + " events_ms"] = events_ms(
                            lambda: fn(x, pad))
    return out


SHIFTS16 = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]


def measure_flagship() -> dict:
    """The live flagship block of the checkout on sys.path[0], per tier:
    CUDA events (ms a block, best of 3 windows of 200), the host clock's
    median (ms) and the host's cost of the block's two conv calls (us a
    pair, best of 5 windows of 2000). Where the checkout's kernels are
    operators (``cached_conv.OPS``), the pair is measured four times more
    with the dispatcher bypassed (the operators' CUDA impls called
    straight from the wrappers: the launch as it was before the
    registration) and through the operators, in turn; where the impls
    check their operands, the checks alone are timed too."""
    import contextlib
    import time

    import numpy as np
    import torch

    from pqmf_tpu_torch import PQMFPitchShiftWrapper
    from pqmf_tpu_torch.kernels import cached_conv as cc

    @contextlib.contextmanager
    def impls_direct():
        ops = cc.OPS

        class Direct:
            analysis_conv = type("A", (), {"default": staticmethod(
                cc._analysis_cuda)})
            synthesis_conv = type("S", (), {"default": staticmethod(
                cc._synthesis_cuda)})

        cc.OPS = Direct
        try:
            yield
        finally:
            cc.OPS = ops

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8192)).astype(np.float32) * 0.3).cuda()
    out = {}
    for tier in ("highest", "bf16x3", "default"):
        w = PQMFPitchShiftWrapper(100, 16, 8192, 44100, SHIFTS16,
                                  precision=tier, device="cuda")
        sp, xb = w.pqmf, x[None]
        sub = sp.forward(xb)
        state = [w.init_state()]
        for _ in range(20):
            state[0], _ = w.pitchshift_fn(state[0], x)
        torch.cuda.synchronize()

        def block_ms():
            best = float("inf")
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(200):
                    state[0], _ = w.pitchshift_fn(state[0], x)
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / 200)
            return best

        def pair_us():
            # the card's ~12 us of K1 + K2 a pair runs behind the enqueue
            best = float("inf")
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    sp.forward(xb)
                    sp.inverse(sub)
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) / 2000 * 1e6)
            return best

        out[f"flagship block {tier} events ms"] = block_ms()
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            state[0], _ = w.pitchshift_fn(state[0], x)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        out[f"flagship block {tier} host median ms"] = float(
            np.median(host))
        out[f"K1+K2 calls {tier} host us"] = pair_us()
        if hasattr(cc, "OPS"):
            # the two routes in turn, so that the spread of one route's
            # passes shows beside the gap between the routes
            op, direct = [], []
            for _ in range(4):
                with impls_direct():
                    direct.append(pair_us())
                op.append(pair_us())
            out[f"K1+K2 calls {tier} host us, impls direct x4"] = direct
            out[f"K1+K2 calls {tier} host us, through the op x4"] = op
        if hasattr(cc, "_check_operands"):
            out[f"K1+K2 operand checks {tier} host us"] = checks_us(
                cc, sp, xb, sub)
    return out


def checks_us(cc, sp, xb, sub) -> float:
    """The host's cost of the operand checks of one block's K1 + K2 calls
    (``cached_conv._analysis_operands`` / ``_synthesis_operands`` on the
    arguments the operators get), us a pair, best of 5 windows of 2000."""
    import time

    seen = {}
    ops = cc.OPS

    class Record:
        def __getattr__(self, name):
            def default(*args):
                seen[name] = args
                return getattr(ops, name).default(*args)
            return type("R", (), {"default": staticmethod(default)})

    cc.OPS = Record()
    try:
        sp.forward(xb)
        sp.inverse(sub)
    finally:
        cc.OPS = ops
    a, s = seen["analysis_conv"], seen["synthesis_conv"]
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            cc._analysis_operands(a[0], a[1], a[2], a[7])
            cc._synthesis_operands(s[0], s[1], s[2], s[7])
        best = min(best, (time.perf_counter() - t0) / 2000 * 1e6)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--what", choices=("tiers", "flagship", "bands"),
                   default="tiers",
                   help="the tier kernels' device times (default), the "
                        "live flagship block, or K3/K3t at M = 32 and 64")
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.measure:  # the child: this process times the checkout it runs in
        sys.path.insert(0, os.getcwd())
        print(json.dumps({"flagship": measure_flagship,
                          "bands": measure_bands,
                          "tiers": measure}[args.what]()))
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
                 "--what", args.what, "--measure"], cwd=root,
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            print(json.dumps({"checkout": name, "root": str(root),
                              "round": r,
                              ("flagship_ms" if args.what == "flagship"
                               else "device_us"): json.loads(
                                  res.stdout.strip().splitlines()[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
