#!/usr/bin/env python3
"""Smoke run of pqmf_tpu_torch on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and ``nvcc`` and
fails without them; it never falls back to the CPU and imports no JAX.

1. Prints the card (``nvidia-smi`` name and power limit), turns TF32 off
   for cuDNN and cuBLAS, and builds the CUDA kernels from
   ``pqmf_tpu_torch/csrc`` (timed).
2. Holds each kernel — K1 analysis, K2 synthesis, K3 fused round trip —
   against its plain PyTorch version on the card, at the flagship's shapes
   and at edge cases.
3. Drives the flagship (``PQMFPitchShiftWrapper``, atten 100, 16 bands,
   8192-sample blocks, 16 fixed shifts) on the card: 8 stateful blocks, one
   16-stream step and one ``forward_fn``, each >= 90 dB against the same
   wrapper on the CPU, carried state included; the launch counters must
   show one K1 + one K2 per pitch-shift step and one K3 per round trip.
4. Times each kernel against its plain version, the flagship block, the
   16-stream step and the 60 s round trip with CUDA events.

The last two lines are ``{"kernels": [...]}`` and ``{"ok": true, ...}``.
Any failure raises and the exit code is non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SR = 44100
BLOCK = 8192
N_BAND = 16
SHIFTS16 = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
BAR_DB = 90.0
K12_TOL = dict(atol=2e-5, rtol=1e-4)  # pqmf_tpu's own kernel-vs-lax bar
K3_TOL = dict(atol=1e-5, rtol=0.0)    # recomputed halo: another tap order


def _audio(n: int, seed: int, batch: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f = rng.uniform(110, 1760, (batch, 1))
    x = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(
        (batch, n))
    return x.astype(np.float32)


def _headline_signal(n: int) -> np.ndarray:
    """bench.py's 60 s signal: a 440 Hz sine plus seeded noise."""
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / SR
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n).astype(np.float32)).astype(
                np.float32)


def _profile(step, n: int, step_ms: float, top: int = 8) -> dict:
    """torch.profiler over ``n`` calls of ``step`` after warm-up: the
    device time of the kernels per call, the card's idle share of a step
    that takes ``step_ms`` unprofiled, and the kernels with the most
    device time (us per call, launches per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / n
    return {
        "step_ms": step_ms, "profiled_step_ms": profiled_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
        "kernels_per_call": sum(e.count for e in rows) / n,
        "top_us": [[e.key[:60], dev_us(e) / n, e.count / n]
                   for e in rows[:top]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the "
              "card", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from pqmf_tpu_torch import PQMFPitchShiftWrapper, StreamingPQMF
    from pqmf_tpu_torch.kernels import _build
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.utils.metrics import aligned_roundtrip_snr_db, snr_db

    dev = torch.device("cuda")

    # -- 1. card, precision, build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"cc {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    bank = StreamingPQMF(100, N_BAND)
    hkf, hki = bank.hkf, bank.hki
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    for i, which in enumerate(("analysis", "synthesis", "roundtrip"), 1):
        c_bytes = lib.pqmf_smem_bytes(i, N_BAND, N_BAND, Ka, Ks)
        assert c_bytes == cc.smem_bytes(which, N_BAND, N_BAND, Ka, Ks), which
        print(f"smem {which}: {c_bytes} B")
    wa, ws = hkf.to(dev), hki.to(dev)

    # -- 2. kernels vs plain, on the card -------------------------------------
    errs = {"analysis": 0.0, "synthesis": 0.0, "roundtrip": 0.0}

    def check(name, got, ref, tol, what):
        torch.cuda.synchronize()
        assert got.shape == ref.shape, (what, got.shape, ref.shape)
        assert torch.isfinite(got).all(), what
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"{what}: {m}")
        errs[name] = max(errs[name], err)
        print(f"  {what}: max|err| {err:.3g}")

    gen = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    print("kernels vs plain:")
    pad_a = Ka - 1  # centered (256, 256)
    for B, T in [(1, BLOCK), (16, BLOCK), (3, 16 * 37 + 5)]:
        for fuse in (True, False):
            x = rand(B, 1, T + pad_a)
            check("analysis", cc.strided_analysis_conv(x, wa, 16, fuse),
                  cc.analysis_conv_plain(x, wa, 16, fuse), K12_TOL,
                  f"K1 x{tuple(x.shape)} fuse_mask={fuse}")
    for B, T in [(1, BLOCK // 16), (16, BLOCK // 16), (3, 37)]:
        for fuse, off in [(True, -16), (True, -15), (True, 3), (True, 0),
                          (False, 0)]:
            x = rand(B, 16, T + Ks - 1)
            check("synthesis",
                  cc.dense_synthesis_conv(x, ws, fuse, off),
                  cc.synthesis_conv_plain(x, ws, fuse, off), K12_TOL,
                  f"K2 x{tuple(x.shape)} fuse_mask={fuse} x_offset={off}")
    sixty = _headline_signal(60 * SR)
    x60 = F.pad(torch.from_numpy(sixty).to(dev)[None, None], (256, 256))
    for x, pad in [(rand(1, 1, BLOCK + pad_a), (16, 16)), (x60, (16, 16)),
                   (rand(2, 1, 16 * 300 + pad_a + 7), (3, 0)),
                   (rand(1, 1, 16 * 129 + pad_a), (0, 40))]:
        check("roundtrip", cc.fused_roundtrip_conv(x, wa, ws, 16, pad),
              cc.roundtrip_conv_plain(x, wa, ws, 16, pad), K3_TOL,
              f"K3 x{tuple(x.shape)} syn_pad={pad}")

    # the plain version on the card may sum in the kernel's own order; the
    # CPU's plain version sums in another, an independent check
    x = rand(2, 1, BLOCK + pad_a)
    sub = F.pad(cc.strided_analysis_conv(x, wa, 16), (16, 16))
    for what, got, ref in [
            ("K1", cc.strided_analysis_conv(x, wa, 16),
             cc.analysis_conv_plain(x.cpu(), hkf, 16)),
            ("K2", cc.dense_synthesis_conv(sub, ws, True, -16),
             cc.synthesis_conv_plain(sub.cpu(), hki, True, -16)),
            ("K3", cc.fused_roundtrip_conv(x, wa, ws, 16, (16, 16)),
             cc.roundtrip_conv_plain(x.cpu(), hkf, hki, 16, (16, 16)))]:
        got = got.cpu()
        torch.testing.assert_close(got, ref, **K12_TOL)
        print(f"  {what} vs the CPU's plain version: max|err| "
              f"{(got - ref).abs().max().item():.3g}")

    # -- 3. the slice on the card vs the port on the CPU ----------------------
    gpu = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR,
                                shifts_in_semitones=SHIFTS16, device="cuda")
    cpu = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR,
                                shifts_in_semitones=SHIFTS16, device="cpu")
    blocks = np.split(_audio(8 * BLOCK, 2), 8, axis=-1)
    streams = _audio(BLOCK, 3, batch=16)

    cc.reset_launches()
    gs, g_out = gpu.init_state(), []
    for blk in blocks:
        gs, y = gpu.pitchshift_fn(gs, blk)
        g_out.append(y)
    gss, g_streams = gpu.pitchshift_streams(gpu.init_streams(16), streams)
    g_rt = gpu.forward_fn(blocks[0])
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)
    print(f"main-path launches: {launches}")
    assert launches == {"analysis": 9, "synthesis": 9, "roundtrip": 1}, \
        launches

    cs = cpu.init_state()
    for i, blk in enumerate(blocks):
        cs, y = cpu.pitchshift_fn(cs, blk)
        assert g_out[i].shape == (1, BLOCK) and torch.isfinite(g_out[i]).all()
        db = snr_db(y.numpy(), g_out[i].cpu().numpy())
        print(f"  block {i}: {db:.1f} dB vs CPU")
        assert db >= BAR_DB, (i, db)
    db = snr_db(cs["prev_tail"].numpy(), gs["prev_tail"].cpu().numpy())
    print(f"  carried tail after 8 blocks: {db:.1f} dB")
    assert db >= BAR_DB
    css, c_streams = cpu.pitchshift_streams(cpu.init_streams(16), streams)
    assert g_streams.shape == (16, BLOCK)
    for what, a, b in [("16 streams", c_streams, g_streams),
                       ("16 stream tails", css["prev_tail"],
                        gss["prev_tail"])]:
        db = snr_db(a.numpy(), b.cpu().numpy())
        print(f"  {what}: {db:.1f} dB")
        assert db >= BAR_DB, what
    db = snr_db(cpu.forward_fn(blocks[0]).numpy(), g_rt.cpu().numpy())
    print(f"  forward_fn: {db:.1f} dB")
    assert db >= BAR_DB
    pq = gpu.pqmf
    y60 = pq.roundtrip(torch.from_numpy(sixty).to(dev)[None, None])
    rt_db = aligned_roundtrip_snr_db(sixty, y60[0, 0].cpu().numpy(),
                                     pq.centered_delay)
    print(f"60 s round trip (K3) whole-signal SNR: {rt_db:.4f} dB")
    assert rt_db >= 65.0, rt_db  # the design's floor on this signal: 65.2

    # -- 4. times, CUDA events after warm-up -----------------------------------
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

    def pair_ms(kern, plain, iters):
        """plain, kernel, kernel, plain; the better of each pair."""
        p1, k1 = cuda_ms(plain, iters), cuda_ms(kern, iters)
        k2, p2 = cuda_ms(kern, iters), cuda_ms(plain, iters)
        return min(k1, k2), min(p1, p2), [p1, k1, k2, p2]

    cases = {
        "analysis": [("B=1 [1,1,8704]", rand(1, 1, BLOCK + pad_a), 200),
                     ("B=16 [16,1,8704]", rand(16, 1, BLOCK + pad_a), 100)],
        "synthesis": [("B=1 [1,16,544]", rand(1, 16, 544), 200),
                      ("B=16 [16,16,544]", rand(16, 16, 544), 100)],
        "roundtrip": [("60 s [1,1,2646512]", x60, 20),
                      ("block [1,1,8704]", rand(1, 1, BLOCK + pad_a), 200)],
    }
    calls = {
        "analysis": (lambda x: cc.strided_analysis_conv(x, wa, 16),
                     lambda x: cc.analysis_conv_plain(x, wa, 16)),
        "synthesis": (lambda x: cc.dense_synthesis_conv(x, ws, True, -16),
                      lambda x: cc.synthesis_conv_plain(x, ws, True, -16)),
        "roundtrip": (lambda x: cc.fused_roundtrip_conv(x, wa, ws, 16,
                                                        (16, 16)),
                      lambda x: cc.roundtrip_conv_plain(x, wa, ws, 16,
                                                        (16, 16))),
    }
    times = {}
    print(f"times on {card} (CUDA events, ms per call):")
    for name, rows in cases.items():
        kern, plain = calls[name]
        for label, x, iters in rows:
            k, p, raw = pair_ms(lambda: kern(x), lambda: plain(x), iters)
            times.setdefault(name, (k, p))  # the first row is the headline
            print(f"  {name} {label}: kernel {k:.4f} plain {p:.4f} "
                  f"(p,k,k,p {[round(v, 4) for v in raw]})")

    state = {"s": gpu.init_state()}

    def flagship_step():
        state["s"], _ = gpu.pitchshift_fn(state["s"], blocks[1])

    def latency_ms(step, n):
        """Host clock per call, each ending in a synchronize: the block
        latency a real-time host sees (median, p90, n)."""
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        lat = []
        for _ in range(n):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        return (float(np.median(lat)), float(np.percentile(lat, 90)), n)

    block_ms = cuda_ms(flagship_step, 50)
    block_lat = latency_ms(flagship_step, 100)
    sstate = {"s": gpu.init_streams(16)}

    def streams_step():
        sstate["s"], _ = gpu.pitchshift_streams(sstate["s"], streams)

    streams_ms = cuda_ms(streams_step, 30)
    streams_lat = latency_ms(streams_step, 100)
    rt_ms = times["roundtrip"][0]
    summary = {
        "card": card,
        "flagship_block_ms": block_ms,
        "flagship_block_rtf": (BLOCK / SR) / (block_ms / 1e3),
        "flagship_block_latency_ms_median_p90_n": block_lat,
        "streams16_step_ms": streams_ms,
        "streams16_rtf": 16 * (BLOCK / SR) / (streams_ms / 1e3),
        "streams16_latency_ms_median_p90_n": streams_lat,
        "roundtrip_60s_ms": rt_ms,
        "roundtrip_60s_rtf": 60.0 / (rt_ms / 1e3),
        "roundtrip_60s_snr_db": rt_db,
    }
    print(json.dumps(summary))

    # where a step's time goes: kernels by device time, and the share of
    # the step's wall time the card is busy at all
    for label, step, ms in [("flagship block", flagship_step, block_ms),
                            ("16-stream step", streams_step, streams_ms)]:
        print(json.dumps({"profile": label, **_profile(step, 10, ms)}))

    replaces = {"analysis": "pqmf_tpu/kernels/cached_conv.py:408",
                "synthesis": "pqmf_tpu/kernels/cached_conv.py:542",
                "roundtrip": "pqmf_tpu/kernels/cached_conv.py:794"}
    names = {"analysis": "K1 strided_analysis_conv",
             "synthesis": "K2 dense_synthesis_conv",
             "roundtrip": "K3 fused_roundtrip_conv"}
    kernels = [{"name": names[k], "route": "cuda",
                "source": "pqmf_tpu_torch/csrc/cached_conv.cu",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in names]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
