#!/usr/bin/env python3
"""Checks of the port on the card, answering ``tools/tpu_checks.py``'s for
``pqmf_tpu_torch`` line by line.

    python tools/gpu_checks.py [--device cuda]

Run from the root of a checkout; prints one PASS / FAIL line per check and
ends with ``ALL PASS``, or exits non-zero. It imports nothing of JAX or of
the JAX package. The checks (``tools/tpu_checks.py`` lines in brackets):

- the M = 2 round trip: K3 against K1 then K2, and its SNR on white noise
  (> 50 dB) [:91-100];
- the committed fine-tuned banks at M = 8, 32 and 64 on bench.py's 60 s
  signal: the steady-state round-trip SNR above the JAX package's floors
  and within 0.5 dB of the port on the CPU [:155-160] (the banks'
  reconstruction error, -102 to -108 dB, is as small as f32 rounding over
  their 512-2048-tap sums, so another summation order moves the SNR: the
  card reads 0.005 / 0.13 / 0.14 dB from the CPU at M = 8 / 32 / 64, the
  same through K3 as through K1 then K2, whose order K3 keeps); each
  round trip is one K3 launch and no K1 or K2 (on the card);
- band-shard K1 / K2 at Mb = 8 against the full bank's bands [:201-207];
- the TA wrapper's fused pitch shift against its per-band loop (> 80 dB)
  [:218];
- the ``bf16x3`` round trip against ``highest`` (peak-relative) [:167];
- the ahead-of-time artifact: the flagship's ``torch.export`` program,
  saved and reloaded, against the live wrapper over two blocks, the tail
  carried (<= 1e-6; bit-equal expected) [:245-258]. It repeats, small, what
  ``tests/test_torch_cuda.py -k aot`` holds for each kind and tier and for
  five programs over 8 blocks in a fresh process: it is kept so the script
  answers for every check of ``tools/tpu_checks.py``;
- fast serving: the ``default``-tier flagship against ``highest`` on one
  8192 block (> 30 dB) [:261-270].

``tests/test_torch_cuda.py::test_gpu_checks_pass`` runs this script on the
card and prints its lines; a card call needs no second run of it.
``--device cpu`` rehearses the same checks on the plain versions.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SR = 44100
SHIFTS16 = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
# the JAX package's floors for the committed banks (tools/tpu_checks.py)
FINETUNED_FLOORS = {8: 99.0, 32: 99.0, 64: 98.0}
# card against the CPU port, in dB of SNR: f32 summation orders (above)
FINETUNED_CPU_DB = 0.5


def bench_signal(seconds: float = 60.0) -> np.ndarray:
    """bench.py's test signal (a 440 Hz sine plus seeded noise), copied."""
    n = int(round(seconds * SR))
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / SR
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n).astype(np.float32)).astype(
                np.float32)


def check(name: str, err: float, tol: float) -> bool:
    ok = err <= tol
    print(f"{'PASS' if ok else 'FAIL'}  {name}: err={err:.3e} (tol {tol:g})")
    return ok


def floor(name: str, value: float, need: float) -> bool:
    ok = value > need
    print(f"{'PASS' if ok else 'FAIL'}  {name}: {value:.2f} dB "
          f"(need > {need:g})")
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where to run (default: the card)")
    args = p.parse_args(argv)

    import torch

    from pqmf_tpu_torch import (PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, StreamingPQMF)
    from pqmf_tpu_torch.export import load_stablehlo, save_artifact
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.parallel.training import (load_pretrained_bank,
                                                  roundtrip_snr)
    from pqmf_tpu_torch.utils.metrics import aligned_roundtrip_snr_db, snr_db

    dev = args.device
    if dev == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(f"card: {card}")
    else:
        print("device: cpu (the plain versions)")
    ok = True
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the M = 2 round trip: K3 against K1 then K2, and its quality
    sp2 = StreamingPQMF(100, 2, device=dev)
    x2 = on(rng.standard_normal((1, 1, 2 * 4096)).astype(np.float32))
    rt2 = sp2.roundtrip(x2)
    ok &= check("M=2 round trip (K3) == K1 then K2",
                (rt2 - sp2.inverse(sp2.forward(x2))).abs().max().item(),
                1e-5)
    ok &= floor("M=2 round trip SNR (whole signal, white noise)",
                aligned_roundtrip_snr_db(x2[0, 0].cpu().numpy(),
                                         rt2[0, 0].cpu().numpy(),
                                         sp2.centered_delay), 50.0)

    # the committed fine-tuned banks on bench.py's signal
    sixty = bench_signal()
    for m, need in FINETUNED_FLOORS.items():
        bank = load_pretrained_bank(f"hk{m}_atten100_finetuned")
        cc.reset_launches()
        got = roundtrip_snr(bank, 100, m, sixty, device=dev)
        ok &= floor(f"fine-tuned M={m} bank, 60 s steady-state SNR", got,
                    need)
        if dev != "cpu":
            launches = dict(cc.LAUNCHES)
            ok &= check(f"fine-tuned M={m} round trip: one K3, no K1/K2 "
                        f"({launches})",
                        float(launches != {"analysis": 0, "synthesis": 0,
                                           "roundtrip": 1}), 0.0)
            ref = roundtrip_snr(bank, 100, m, sixty, device="cpu")
            ok &= check(f"fine-tuned M={m} SNR, card vs CPU port (dB)",
                        abs(got - ref), FINETUNED_CPU_DB)

    # band-shard K1 / K2 (Mb = 8 of 16)
    sp = StreamingPQMF(100, 16, device=dev)
    Ka = sp.hkf.shape[-1]
    xs = on(rng.standard_normal((1, 1, 16 * 512 + Ka - 16)).astype(
        np.float32))
    full = cc.strided_analysis_conv(xs, sp.hkf, 16)
    shard = cc.strided_analysis_conv(xs, sp.hkf[4:12].contiguous(), 16)
    ok &= check("band-shard analysis (Mb=8)",
                (full[:, 4:12] - shard).abs().max().item(), 5e-5)
    ss = on(rng.standard_normal((1, 16, 544)).astype(np.float32))
    masked = torch.where(torch.arange(16, device=dev)[None, :, None] < 8,
                         ss, torch.zeros_like(ss))
    ref_sh = cc.dense_synthesis_conv(masked, sp.hki)
    got_sh = cc.dense_synthesis_conv(ss[:, :8].contiguous(),
                                     sp.hki[:, :8].contiguous())
    ok &= check("band-shard synthesis (Mb=8)",
                (ref_sh - got_sh).abs().max().item(), 5e-5)

    # the TA wrapper's fused pitch shift against its per-band loop
    xb = rng.standard_normal((1, 8192)).astype(np.float32) * 0.3
    wta = PQMFPitchShiftWrapperTA(100, 16, 8192, SR, SHIFTS16, device=dev)
    ok &= floor("TA fused vs per-band loop",
                snr_db(wta.pitchshifter_loop(xb[None]).cpu().numpy(),
                       wta.pitchshifter(xb[None]).cpu().numpy()), 80.0)

    # the bf16x3 tier against highest
    x = on(rng.standard_normal((1, 1, 16 * 512)).astype(np.float32))
    r_hi = sp.roundtrip(x)
    r_x3 = StreamingPQMF(100, 16, precision="bf16x3",
                         device=dev).roundtrip(x)
    ok &= check("bf16x3 round trip vs highest (peak-relative)",
                ((r_x3 - r_hi).abs().max() / r_hi.abs().max()).item(), 5e-5)

    # the ahead-of-time artifact, reloaded, against the live wrapper
    w = PQMFPitchShiftWrapper(100, 16, 8192, SR, SHIFTS16, device=dev)
    with tempfile.TemporaryDirectory() as td:
        program = load_stablehlo(save_artifact(w, td, with_stablehlo=True),
                                 device=dev)
        tail_a = tail_l = w.init_state()["prev_tail"]
        err = 0.0
        for blk in (xb, rng.standard_normal((1, 8192)).astype(
                np.float32) * 0.3):
            tail_a, y_aot = program(tail_a, on(blk))
            state, y_live = w.pitchshift_fn({"prev_tail": tail_l}, on(blk))
            tail_l = state["prev_tail"]
            err = max(err, (y_aot - y_live).abs().max().item(),
                      (tail_a - tail_l).abs().max().item())
    ok &= check("AOT program reload == live wrapper (2 blocks, tail)", err,
                1e-6)

    # fast serving: the default tier's flagship against highest
    w_lo = PQMFPitchShiftWrapper(100, 16, 8192, SR, SHIFTS16,
                                 precision="default", device=dev)
    _, y_lo = w_lo.pitchshift_fn(w_lo.init_state(), on(xb))
    _, y_hi = w.pitchshift_fn(w.init_state(), on(xb))
    ok &= floor("fast-serving (default) flagship vs highest",
                snr_db(y_hi.cpu().numpy(), y_lo.cpu().numpy()), 30.0)

    print("ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
