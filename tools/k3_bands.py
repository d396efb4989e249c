#!/usr/bin/env python3
"""The fused round trip at M = 32 and 64 on one NVIDIA card: how often the
``default``-tier K3t lands past K3's bar, and what the entry points pay
for one K3 against the K1 + K2 they ran before.

    python3 tools/k3_bands.py [--what offshare|entry|both]

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``. Prints the card's name and power limit, then one JSON line per
case.

``offshare``: K3t (``fused_roundtrip_conv``) and K6 over it
(``polyphase_roundtrip``) at ``default`` against their plain versions at
the same tier, at M = 16, 32 and 64, designed and committed fine-tuned
banks: unit-variance seeded noise at a host block (B = 1, 3, 16), at 300
sub-band steps (B = 2) and at ``n_sms * 256 + 64`` steps (B = 1, the
persistent plan), and the 60 s ``bench_signal`` (analysis pad in the
kernel). Each line gives the share of outputs past K3_TOL (1e-5), the
largest error and the one-flip bound of ``tests/test_torch_cuda.py``'s
``assert_k3t_close``.

``entry``: ``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip`` with the
committed fine-tuned bank at M = 32 and 64 at each tier, on one host
block ([1, 1, 8192]) and on the 60 s signal, routed through K3/K3t (this
tree) and through K1 + K2 (``fused_roundtrip_supported`` made to refuse
M >= 32, the route before K3 took these M): ms a call by CUDA events
(k3, k1k2, k1k2, k3; the better of each pair) and, at the host block, the
host clock's median over 200 synchronized calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SR = 44100
BLOCK = 8192
K3_ATOL = 1e-5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _share(got, ref, sub, w_syn) -> dict:
    import torch

    M = w_syn.shape[0]
    ulp = 2.0 ** (torch.floor(torch.log2(sub.abs().max())).item() - 7)
    bound = ulp * w_syn.abs().sum(dim=tuple(range(1, w_syn.ndim))).max() \
        .item() * M
    err = (got - ref).abs()
    return {"off": (err > K3_ATOL).float().mean().item(),
            "max_err": err.max().item(), "bound": bound + K3_ATOL}


def offshare(sixty) -> None:
    import torch

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    raw60 = torch.from_numpy(sixty).cuda()[None, None]
    for M in (16, 32, 64):
        for kind in ("designed", "finetuned"):
            sp = StreamingPQMF(100, M, device="cuda")
            pq = PQMF(100, M, device="cuda")
            if kind == "finetuned":
                bank = load_pretrained_bank(f"hk{M}_atten100_finetuned")
                sp.set_weights(bank)
                pq.set_weights(bank)
            wa, ws = sp.hkf, sp.hki
            ka, ks = wa.shape[-1], ws.shape[-1]
            cases = []
            for seed in range(5):
                g = torch.Generator().manual_seed(seed)
                for B, steps in [(1, BLOCK // M), (3, BLOCK // M),
                                 (16, BLOCK // M), (2, 300),
                                 (1, n_sms * 256 + 64)]:
                    if seed >= 3 and B != 1:
                        continue
                    x = torch.randn(B, 1, M * steps + ka - 1,
                                    generator=g).cuda()
                    cases.append((f"noise B={B} steps={steps} seed={seed}",
                                  x, (0, 0)))
            cases.append(("60 s", raw60, (ka // 2, ka // 2)))
            syn = (ks // 2, ks // 2)
            for what, x, apad in cases:
                got = cc.fused_roundtrip_conv(x, wa, ws, M, syn, "default",
                                              pad=apad)
                ref = cc.roundtrip_conv_plain(x, wa, ws, M, syn, "default",
                                              pad=apad)
                sub = cc.strided_analysis_conv(x, wa, M, pad=apad)
                print(json.dumps({"kernel": "K3t", "M": M, "bank": kind,
                                  "case": what, "T_out": ref.shape[1],
                                  **_share(got, ref, sub, ws)}), flush=True)
            hp, hi, w2 = pq.params["hk_poly"], pq.params["hk_ipoly"], pq._w2
            g = torch.Generator().manual_seed(7)
            for what, x in [("noise B=1 block",
                             torch.randn(1, 1, BLOCK, generator=g).cuda()),
                            ("noise B=16 block",
                             torch.randn(16, 1, BLOCK, generator=g).cuda()),
                            ("60 s", raw60[..., : raw60.shape[-1] // M * M])]:
                got = pk.polyphase_roundtrip(x, hp, hi, w2, "default")
                ref = pk.polyphase_roundtrip_plain(x, hp, hi, "default")
                sub = pk.polyphase_analysis(x, hp, w2)
                print(json.dumps({"kernel": "K6t", "M": M, "bank": kind,
                                  "case": what, **_share(got, ref, sub, hi)}),
                      flush=True)


def entry(sixty) -> None:
    import torch

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    fused = cc.fused_roundtrip_supported

    def k1k2_gate(M, *args, **kwargs):
        return M < 32 and fused(M, *args, **kwargs)

    def cuda_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def host_ms(fn, n):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        lat = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        return float(np.median(lat))

    def routed(route, fn):
        cc.fused_roundtrip_supported = fused if route == "k3" else k1k2_gate
        try:
            return fn()
        finally:
            cc.fused_roundtrip_supported = fused

    g = torch.Generator().manual_seed(0)
    block = torch.randn(1, 1, BLOCK, generator=g).cuda()
    for M in (32, 64):
        bank = load_pretrained_bank(f"hk{M}_atten100_finetuned")
        x60 = torch.from_numpy(sixty[: len(sixty) // M * M]).cuda()[None,
                                                                  None]
        for tier in ("highest", "bf16x3", "default"):
            for name, cls in [("StreamingPQMF", StreamingPQMF),
                              ("PQMF", PQMF)]:
                obj = cls(100, M, precision=tier, device="cuda")
                obj.set_weights(bank)
                for shape, x, iters in [("block [1,1,8192]", block, 200),
                                        ("60 s", x60, 20)]:
                    counts = {}
                    for route in ("k3", "k1k2"):
                        cc.reset_launches()
                        routed(route, lambda: obj.roundtrip(x))
                        torch.cuda.synchronize()
                        counts[route] = dict(cc.LAUNCHES)
                    ms = {r: [] for r in ("k3", "k1k2")}
                    for route in ("k3", "k1k2", "k1k2", "k3"):
                        ms[route].append(routed(route, lambda: cuda_ms(
                            lambda: obj.roundtrip(x), iters)))
                    line = {"entry": f"{name}.roundtrip", "M": M,
                            "tier": tier, "shape": shape,
                            "k3_ms": min(ms["k3"]),
                            "k1k2_ms": min(ms["k1k2"]),
                            "raw_ms": ms, "launches": counts}
                    if shape.startswith("block"):
                        line["host_median_ms"] = {
                            r: routed(r, lambda: host_ms(
                                lambda: obj.roundtrip(x), 200))
                            for r in ("k3", "k1k2")}
                    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", choices=("offshare", "entry", "both"),
                    default="both")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pqmf_tpu_torch.cli.finetune_bank import bench_signal

    print(_card())
    sixty = bench_signal(60 * SR)
    if args.what in ("offshare", "both"):
        offshare(sixty)
    if args.what in ("entry", "both"):
        entry(sixty)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
