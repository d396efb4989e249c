#!/usr/bin/env python3
"""Times of the port's CUDA kernels on one NVIDIA card: the rows of
PERF.md's kernel table.

    python3 tools/kernel_times.py > kernels.log

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``; it imports no JAX. Prints the card's name and power limit, one
JSON line a row and last a ``{"kernels": [...]}`` line with every row. A
row is one kernel at one shape and tier: ms a call by CUDA events (plain,
kernel, kernel, plain; the better of each pair) beside its plain PyTorch
version, the hand-written kernels a call launched (``launches``, counted
over the timed calls: a row whose calls launched any other count fails
the run), the device time of one call (``_device_us``, never more than
its events time), the largest error against the plain version (the card
tests hold the bars), where one ``F.conv1d`` computes the same
product its events and device time (``library_*``: cuDNN's f32 conv at
``highest``; at the tiers one TF32 conv of the bf16-split operands, and
its error), and the least time the card could take for the call's FMAs or
bytes (``benchmark/roofline.py`` at ``highest``,
``benchmark/roofline_tier.py`` at the tiers, three passes at ``bf16x3``):

- K1-K6 and K1t-K6t (reading their kept arranged banks) at the headline
  shapes: host blocks of 8192 at B = 1 and 16, K3 also on 60 s and at
  ``stream_ola``'s 215 x 4096, K4-K6 on 60 s and a block;
- K3/K3t at M = 32 and 64 on 60 s and at host blocks of B = 1 and 16,
  beside K1 + K2 (K1t + K2t) on the same input, with the launch plans; K6
  at M = 32 and 64 on 60 s beside K4 + K5;
- the flagship's middle at 1 and 128 streams: ``pv_frame_kernel``,
  ``pv_spectral_kernel`` and ``pv_resynth_kernel`` on the card's own
  inputs, the two DFT products' TFLOP/s and the whole middle against its
  bound (a ``{"middle": ...}`` line);
- K1/K2 (K1t/K2t) and K4/K5 on rank 0's band shard of Mb = 8 and 4 bands.

``tests/test_torch_cuda.py`` checks these kernels; this tool only times
them. ``tools/tier_ab.py`` takes ``_device_us`` from here.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parent.parent

SR, BLOCK, N_BAND = 44100, 8192, 16
OLA_BLOCK = 4096  # stream_ola's block (overlap 2048): 215 blocks on 10 s
TIERS = ("bf16x3", "default")
PASSES = {"highest": 1, "bf16x3": 3, "default": 1}
NAMES = {"analysis": "K1", "synthesis": "K2", "roundtrip": "K3",
         "polyphase_analysis": "K4", "polyphase_synthesis": "K5",
         "polyphase_roundtrip": "K6"}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _events_ms(fn, iters: int) -> float:
    """ms a call of ``fn`` by CUDA events over ``iters`` calls, after three
    calls of warm-up."""
    import torch

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


def _pair_ms(kern, plain, iters: int) -> tuple:
    """(kernel's two ms readings, plain's two): plain, kernel, kernel,
    plain, each ``_events_ms``. Each of the two runs 2 * (3 + iters)
    calls."""
    p1, k1 = _events_ms(plain, iters), _events_ms(kern, iters)
    k2, p2 = _events_ms(kern, iters), _events_ms(plain, iters)
    return (k1, k2), (p1, p2)


def _launched() -> dict:
    """The hand-written kernels launched since ``_reset_launches``, by
    name: K1-K3 and K1t-K3t (``cached_conv.KERNELS``), K4-K6 (the
    polyphase adapters' ``LAUNCHES``; each also counts the K1-K3 it runs)
    and the middle's three; the ones not launched left out."""
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import middle as pm
    from pqmf_tpu_torch.kernels import polyphase as pk

    got = {**cc.KERNELS,
           **{NAMES["polyphase_" + k]: n for k, n in pk.LAUNCHES.items()},
           **{f"pv_{k}_kernel": n for k, n in pm.LAUNCHES.items()}}
    return {k: n for k, n in got.items() if n}


def _reset_launches() -> None:
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import middle as pm
    from pqmf_tpu_torch.kernels import polyphase as pk

    for mod in (cc, pk, pm):
        mod.reset_launches()


def _check_launches(what: str, per_call: dict, calls: int) -> dict:
    """Fail unless the ``calls`` timed calls since ``_reset_launches``
    launched ``per_call`` kernels each and nothing else; ``per_call``."""
    got = _launched()
    want = {k: n * calls for k, n in per_call.items()}
    if got != want:
        raise RuntimeError(f"{what}: {calls} calls launched {got}, not "
                           f"{want}")
    return per_call


def _expect(kind: str, tier: str) -> dict:
    """The kernels one call of ``kind`` launches at ``tier``: K1-K3 (K1t-K3t)
    once; K4-K6 once, each with the K1-K3 (K1t-K3t) it runs."""
    base = NAMES[kind.replace("polyphase_", "")]
    want = {base + ("" if tier == "highest" else "t"): 1}
    if kind.startswith("polyphase"):
        want[NAMES[kind]] = 1
    return want


def _timed(fn, iters: int, n_dev: int, what: str,
           per_call: dict | None = None) -> tuple:
    """(ms, device us) of a call of ``fn``: the better of two
    ``_events_ms`` readings, and ``_device_us`` held to the longer one.
    With ``per_call``, the timed calls must launch exactly that."""
    _reset_launches()
    ms = (_events_ms(fn, iters), _events_ms(fn, iters))
    if per_call is not None:
        _check_launches(what, per_call, 2 * (3 + iters))
    return min(ms), _device_us(fn, n_dev, 1e3 * max(ms))


def _device_us(fn, n: int, most_us: float | None = None) -> float:
    """Device time per call of ``fn`` (us): the CUDA kernels of the median
    whole call in a torch.profiler trace of 2n calls, after warm-up. A
    trace can lose kernel events (an NVIDIA H100 kept 6-9 of 10 launches
    of a 0.9 ms kernel, and none of one call) and once read a 0.16 ms
    kernel at half its time, so the calls are told apart by their kernel
    names, which repeat with the period of one call's kernels: the trace
    is read only where they do (a lost call keeps the period, a lost part
    of one breaks it), where it holds no more kernels than were launched
    and at least n whole calls survived, and the median call stands for
    all. A median past ``most_us`` (the call's events time: the kernels of
    one call cannot take longer than the call) is a misread trace too.
    Otherwise the trace is taken again; five such traces fail the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * n):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if getattr(e, "device_type", None) == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        names = [e.name for e in ev]
        period = next((p for p in range(1, len(names) // n + 1)
                       if names[p:] == names[:-p]), 0)
        calls = len(ev) // period if period else 0
        if n <= calls <= 2 * n:
            per_call = sorted(
                sum(e.time_range.end - e.time_range.start
                    for e in ev[c * period:(c + 1) * period])
                for c in range(calls))
            if most_us is None or per_call[calls // 2] <= most_us:
                return per_call[calls // 2]
    raise RuntimeError(f"torch.profiler kept no {n} whole calls of at most "
                       f"{most_us} us in 5 traces")


@contextlib.contextmanager
def _tf32():
    """cuDNN's TF32 convolutions on (the library yardstick at the tiers)."""
    import torch

    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def _work(kind: str, shape, M: int, K: int, Ks: int = 0,
          Mb: int | None = None) -> tuple:
    """(FLOP, bytes) of one call of ``kind`` on an input of ``shape`` with
    an M-band bank (Mb of its bands: a band shard) of K taps (Ks synthesis
    taps in a round trip; L taps a phase for the polyphase kernels): its
    FMAs at 2 FLOP, its inputs read and its output written once in f32.
    The work is the function's own: K3's recomputed halo is not counted."""
    B, _, T = shape
    Mb = M if Mb is None else Mb
    if kind == "analysis":            # [B, 1, Tpad] -> [B, Mb, T_out]
        t_out = (T - K) // M + 1
        fma, io = B * t_out * Mb * K, B * T + Mb * K + B * Mb * t_out
    elif kind == "synthesis":         # [B, Mb, Tpad] -> [B, T_out, M]
        t_out = T - K + 1
        fma = B * t_out * M * Mb * K
        io = B * Mb * T + M * Mb * K + B * t_out * M
    elif kind == "roundtrip":         # syn_pad (16, 16)
        t_ana = (T - K) // M + 1
        t_out = t_ana + 32 - Ks + 1
        fma = B * (t_ana * M * K + t_out * M * M * Ks)
        io = B * T + M * K + M * M * Ks + B * t_out * M
    elif kind == "polyphase_analysis":   # [B, 1, T] -> [B, Mb, T/M]
        fma, io = B * T * Mb * K, B * T + B * Mb * T // M + Mb * M * K
    elif kind == "polyphase_synthesis":  # [B, Mb, T'] -> [B, 1, M*T']
        fma, io = B * T * M * Mb * K, B * Mb * T + B * M * T + M * Mb * K
    else:                                # polyphase_roundtrip, [B, 1, T]
        fma, io = 2 * B * T * M * K, 2 * B * T + 2 * M * M * K
    return 2 * fma, 4 * io


def _bound_ms(flop: float, nbytes: float, precision: str) -> tuple:
    """(ms, "operations" | "bytes"): the least time at the peaks of the
    tier (f32 at ``highest``; the bf16 tensor cores, three passes at
    ``bf16x3``)."""
    from benchmark import roofline, roofline_tier

    if precision == "highest":
        s, by = roofline.bound_seconds(flop, nbytes)
    else:
        s, by = roofline_tier.bound_seconds(flop * PASSES[precision], nbytes)
    return s * 1e3, by


def _row(name: str, x, kern, plain, iters: int, work: tuple, tier: str,
         launches: dict, library=None, **extra) -> dict:
    """One timed row: ``kern`` and ``plain`` are calls of ``x``; each call
    of ``kern`` launches ``launches``, each of ``plain`` nothing;
    ``library`` is None or (a call on its prepared operands, its output in
    the kernel's layout or None)."""
    _reset_launches()
    ks, ps = _pair_ms(lambda: kern(x), lambda: plain(x), iters)
    n_dev = 10 if x.numel() > 1 << 20 else 50
    row = {"name": name, "tier": tier, "shape": list(x.shape),
           "launches": _check_launches(name, launches, 2 * (3 + iters)),
           "ms": min(ks), "plain_ms": min(ps),
           "device_us": _device_us(lambda: kern(x), n_dev, 1e3 * max(ks)),
           "max_abs_err": (kern(x) - plain(x)).abs().max().item()}
    row["bound_ms"], row["bound_by"] = _bound_ms(*work, tier)
    if library is not None:
        call, y = library
        ctx = contextlib.nullcontext if tier == "highest" else _tf32
        with ctx():
            row["library_ms"], row["library_device_us"] = _timed(
                call, iters, n_dev, f"{name} library", {})
        if y is not None:
            row["library_max_abs_err"] = (y - plain(x)).abs().max().item()
    row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def _tier_library(kind: str, tier: str, x, w):
    """One F.conv1d that computes K1t's / K2t's product at the tier (and
    K4t's / K5t's, on their adapters' padded operands), cuDNN's TF32 on
    (bf16 values are exact in TF32): "default" conv(xh, wh); "bf16x3" one
    conv over channel-stacked operands, cat(xh, xl, xh) with cat(wh, wh,
    wl). Returns (the call on its prepared operands, its output in the
    kernel's layout)."""
    import torch
    import torch.nn.functional as F

    from pqmf_tpu_torch.ops import filterbank as fb

    xin = {"analysis": lambda v: v,
           "synthesis": lambda v: fb.reverse_half(v, -16),
           "polyphase_analysis": lambda v: F.pad(v, (256, 240)),
           "polyphase_synthesis": lambda v: F.pad(fb.reverse_half(v),
                                                  (15, 16))}[kind](x)
    xh, xl = fb.split_bf16(xin)
    wh, wl = fb.split_bf16(w)
    if tier == "bf16x3":
        xs, ws = torch.cat([xh, xl, xh], 1), torch.cat([wh, wh, wl], 1)
    else:
        xs, ws = xh, wh
    stride = 16 if kind.endswith("analysis") else 1

    def call():
        return F.conv1d(xs, ws, stride=stride)

    with _tf32():
        y = call()
    if kind.endswith("analysis"):
        y = fb.reverse_half(y)
    else:
        y = torch.flip(y * 16, dims=(1,)).transpose(1, 2)
        if kind == "polyphase_synthesis":
            y = y.reshape(y.shape[0], 1, -1)
    return call, y


def headline_rows(rand, raw60) -> list:
    """K1-K6 and K1t-K6t at their headline shapes (the 16-band bank)."""
    import torch.nn.functional as F

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    sp, pq = (StreamingPQMF(100, N_BAND, device="cuda"),
              PQMF(100, N_BAND, device="cuda"))
    wa, ws = sp.hkf, sp.hki
    hp, hi, w2 = pq.params["hk_poly"], pq.params["hk_ipoly"], pq._w2
    Ka, Ks, L = wa.shape[-1], ws.shape[-1], hp.shape[-1]
    x60 = F.pad(raw60, (Ka // 2, Ka // 2))
    sub60 = pk.polyphase_analysis(raw60, hp, w2)
    cases = {  # kind: [(input, iters)], the headline first
        "analysis": [(rand(1, 1, BLOCK + Ka - 1), 200),
                     (rand(16, 1, BLOCK + Ka - 1), 100)],
        "synthesis": [(rand(1, 16, 544), 200), (rand(16, 16, 544), 100)],
        "roundtrip": [(x60, 20), (rand(1, 1, BLOCK + Ka - 1), 200),
                      (rand(16, 1, BLOCK + Ka - 1), 100),
                      (rand(215, 1, OLA_BLOCK + Ka - 1), 50)],
        "polyphase_analysis": [(raw60, 20), (rand(1, 1, BLOCK), 200)],
        "polyphase_synthesis": [(sub60, 20), (rand(1, 16, 512), 200)],
        "polyphase_roundtrip": [(raw60, 20), (rand(1, 1, BLOCK), 200)],
    }
    taps = {"analysis": (Ka,), "synthesis": (Ks,), "roundtrip": (Ka, Ks),
            "polyphase_analysis": (L,), "polyphase_synthesis": (L,),
            "polyphase_roundtrip": (L,)}
    # one PyTorch call of the same product on the kernel's own (padded)
    # operands; timed here, never used by the port. No single call
    # computes K3 or K6.
    weight = {"analysis": wa, "synthesis": ws, "polyphase_analysis": w2,
              "polyphase_synthesis": hi}
    f32_library = {
        "analysis": lambda x: (lambda: F.conv1d(x, wa, stride=16)),
        "synthesis": lambda x: (lambda: F.conv1d(x, ws)),
        "polyphase_analysis": lambda x: (
            lambda xp=F.pad(x, (256, 240)): F.conv1d(xp, w2, stride=16)),
        "polyphase_synthesis": lambda x: (
            lambda xp=F.pad(x, (15, 16)): F.conv1d(xp, hi)),
    }
    rows = []
    for tier in ("highest",) + TIERS:
        kb = {} if tier == "highest" else {
            k: cc.arrange_tc_bank(w, kind, tier) for k, w, kind in (
                ("wa", wa, "analysis"), ("ws", ws, "synthesis"),
                ("w2", w2, "analysis"), ("hi", hi, "synthesis"))}
        pair = (None if tier == "highest" else (kb["wa"], kb["ws"]),
                None if tier == "highest" else (kb["w2"], kb["hi"]))
        calls = {
            "analysis": (
                lambda x: cc.strided_analysis_conv(
                    x, wa, 16, mxu_precision=tier, bank=kb.get("wa")),
                lambda x: cc.analysis_conv_plain(x, wa, 16, precision=tier)),
            "synthesis": (
                lambda x: cc.dense_synthesis_conv(x, ws, True, -16, tier,
                                                  bank=kb.get("ws")),
                lambda x: cc.synthesis_conv_plain(x, ws, True, -16, tier)),
            "roundtrip": (
                lambda x: cc.fused_roundtrip_conv(x, wa, ws, 16, (16, 16),
                                                  tier, banks=pair[0]),
                lambda x: cc.roundtrip_conv_plain(x, wa, ws, 16, (16, 16),
                                                  tier)),
            "polyphase_analysis": (
                lambda x: pk.polyphase_analysis(x, hp, w2, mxu_precision=tier,
                                                tc_bank=kb.get("w2")),
                lambda x: pk.polyphase_analysis_plain(x, hp, tier)),
            "polyphase_synthesis": (
                lambda x: pk.polyphase_synthesis(x, hi, tier, kb.get("hi")),
                lambda x: pk.polyphase_synthesis_plain(x, hi, tier)),
            "polyphase_roundtrip": (
                lambda x: pk.polyphase_roundtrip(x, hp, hi, w2, tier,
                                                 pair[1]),
                lambda x: pk.polyphase_roundtrip_plain(x, hp, hi, tier)),
        }
        for kind, xs in cases.items():
            name = NAMES[kind] + ("" if tier == "highest" else "t")
            for x, iters in xs:
                library = None
                if kind in weight:
                    library = ((f32_library[kind](x), None)
                               if tier == "highest" else
                               _tier_library(kind, tier, x, weight[kind]))
                rows.append(_row(
                    name, x, *calls[kind], iters,
                    _work(kind, x.shape, N_BAND, *taps[kind]), tier,
                    _expect(kind, tier), library))
    return rows


def band_rows(rand, raw60) -> list:
    """K3/K3t at M = 32 and 64 beside K1 + K2 (K1t + K2t), with their
    plans, and K6 at M = 32 and 64 beside K4 + K5."""
    import torch
    import torch.nn.functional as F

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for M in (32, 64):
        sp, pq = (StreamingPQMF(100, M, device="cuda"),
                  PQMF(100, M, device="cuda"))
        wa, ws = sp.hkf, sp.hki
        hp, hi, w2 = pq.params["hk_poly"], pq.params["hk_ipoly"], pq._w2
        ka, ks, L = wa.shape[-1], ws.shape[-1], hp.shape[-1]
        xs = {"60 s": (F.pad(raw60, (ka // 2, ka // 2)), 20),
              "block": (rand(1, 1, BLOCK + ka - 1), 200),
              "block_b16": (rand(16, 1, BLOCK + ka - 1), 100)}
        x6 = raw60[..., : raw60.shape[-1] // M * M]
        for tier in ("highest",) + TIERS:
            kb = None if tier == "highest" else (
                cc.arrange_tc_bank(wa, "analysis", tier),
                cc.arrange_tc_bank(ws, "synthesis", tier))
            tb = None if tier == "highest" else (
                cc.arrange_tc_bank(w2, "analysis", tier),
                cc.arrange_tc_bank(hi, "synthesis", tier))

            def k3(x, tier=tier, kb=kb):
                return cc.fused_roundtrip_conv(x, wa, ws, M, (16, 16), tier,
                                               banks=kb)

            def halves(x, tier=tier, kb=kb):
                sub = cc.strided_analysis_conv(
                    x, wa, M, mxu_precision=tier,
                    bank=None if kb is None else kb[0])
                return cc.dense_synthesis_conv(
                    sub, ws, True, 0, tier, (16, 16),
                    None if kb is None else kb[1])

            def plain(x, tier=tier):
                return cc.roundtrip_conv_plain(x, wa, ws, M, (16, 16), tier)

            name = "K3" if tier == "highest" else "K3t"
            two = {**_expect("analysis", tier), **_expect("synthesis", tier)}
            for tag, (x, iters) in xs.items():
                t_out = (x.shape[-1] - ka) // M + 1 + 32 - ks + 1
                plan = cc.launch_plan(
                    "roundtrip", x.shape[0], M, M, ka, ks, t_out,
                    n_sms=n_sms, precision=tier,
                    max_clusters=cc.max_clusters(M, ka, ks, tier))
                h_ms, h_us = _timed(lambda: halves(x), iters,
                                    10 if tag == "60 s" else 50,
                                    f"{name} M={M} {tag} halves", two)
                rows.append(_row(
                    f"{name} M={M} {tag}", x, k3, plain, iters,
                    _work("roundtrip", x.shape, M, ka, ks), tier,
                    _expect("roundtrip", tier), halves_ms=h_ms,
                    halves_device_us=h_us, plan=list(plan)))

            def k6(x, tier=tier, tb=tb):
                return pk.polyphase_roundtrip(x, hp, hi, w2, tier, tb)

            def k45(x, tier=tier, tb=tb):
                sub = pk.polyphase_analysis(
                    x, hp, w2, mxu_precision=tier,
                    tc_bank=None if tb is None else tb[0])
                return pk.polyphase_synthesis(sub, hi, tier,
                                              None if tb is None else tb[1])

            h_ms, h_us = _timed(
                lambda: k45(x6), 20, 10, f"K4 + K5 M={M} 60 s {tier}",
                {**_expect("polyphase_analysis", tier),
                 **_expect("polyphase_synthesis", tier)})
            rows.append(_row(
                f"K6 (over {name}) M={M} 60 s", x6, k6,
                lambda x, tier=tier: pk.polyphase_roundtrip_plain(
                    x, hp, hi, tier), 20,
                _work("polyphase_roundtrip", x6.shape, M, L), tier,
                _expect("polyphase_roundtrip", tier), halves_ms=h_ms,
                halves_device_us=h_us))
    return rows


def middle_rows(rand) -> list:
    """The flagship's middle (``kernels/middle.py``) at 1 and 128 streams:
    each kernel on the card's own inputs against its plain version, its
    bound its operands read once and its outputs written once at the HBM
    rate; on a ``{"middle": ...}`` line the DFT products' TFLOP/s and the
    whole middle against its bound (the products' FLOPs at the f32 peak,
    or the sub-bands in and the shifted bands and tail out, the larger)."""
    import torch

    from pqmf_tpu_torch import PQMFPitchShiftWrapper
    from pqmf_tpu_torch.kernels import middle as pm
    from pqmf_tpu_torch.ops import stft as S

    dev = torch.device("cuda")
    w = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR, device="cuda")
    fades = (w._fade_out, w._fade_in)
    names = {"frame": "pv_frame_kernel", "spectral": "pv_spectral_kernel",
             "resynth": "pv_resynth_kernel"}
    rows, summary = [], {}
    for B in (1, 128):  # pvoc16.live's block and pvoc16.streams' step
        x = rand(B, 1, BLOCK) * 0.3
        sub = w.pqmf._forward_local(x)  # [B, 16, 512]
        p = w._plan(sub.shape[-1])
        stft_basis, istft_basis = pm.bases(p.n_fft, dev)
        mode, crossfade = ((pm.SHARED_FADE, True) if B == 1
                           else (pm.STREAM_FADE, "batched"))
        g = torch.Generator().manual_seed(B)
        prev = (torch.randn(pm._tail_shape(B, N_BAND, w.band_overlap, mode),
                            generator=g) * 0.1).to(dev)
        frames = pm.frame(sub, p)
        spec = S.dft_matmul(frames, stft_basis)
        rows_ = pm.spectral(spec, p, B, False)
        prod = S.dft_matmul(rows_, istft_basis)
        shifted, tail = pm.resynth(prod, p, B, prev, *fades, mode)
        calls = {
            "frame": (lambda: pm.frame(sub, p), lambda: pm.frame_plain(
                sub, p.window, p.n_fft, p.hop, p.frames)),
            "spectral": (lambda: pm.spectral(spec, p, B, False),
                         lambda: pm.spectral_plain(
                             spec, p.rates, p.table, p.omega, B, p.n_fft,
                             False)),
            "resynth": (lambda: pm.resynth(prod, p, B, prev, *fades, mode),
                        lambda: pm.resynth_plain(
                            prod, p.table, p.wsq, p.window, prev, *fades, B,
                            p.Tb, p.n_fft, p.hop, p.win, mode))}
        io = {"frame": (sub, p.window, frames),
              "spectral": (spec, p.rates, p.table, p.omega, rows_),
              "resynth": (prod, p.table, p.wsq, p.window, prev, *fades,
                          shifted, tail)}
        iters, n_dev = (200, 20) if B == 1 else (50, 20)
        label = f"{B} stream" + ("s" if B > 1 else "")
        for k, (fn, plain) in calls.items():
            name = f"{names[k]} [{label}]"
            _reset_launches()
            ms, plain_ms = _pair_ms(fn, plain, iters)
            bound = _bound_ms(0, 4 * sum(t.numel() for t in io[k]),
                              "highest")
            row = {"name": name, "tier": "highest", "shape": list(sub.shape),
                   "launches": _check_launches(name, {names[k]: 1},
                                               2 * (3 + iters)),
                   "ms": min(ms), "plain_ms": min(plain_ms),
                   "device_us": _device_us(fn, n_dev, 1e3 * max(ms)),
                   "bound_ms": bound[0], "bound_by": bound[1]}
            print(json.dumps(row), flush=True)
            rows.append(row)
        flops = {"stft": 2 * frames.shape[0] * frames.shape[1] * p.n_fft
                 * (p.n_fft + 2),
                 "istft": 2 * rows_.shape[0] * (p.n_fft + 2) * p.n_fft}
        products = {}
        for k, fn in (("stft", lambda: S.dft_matmul(frames, stft_basis)),
                      ("istft", lambda: S.dft_matmul(rows_, istft_basis))):
            ms, us = _timed(fn, iters, n_dev, f"{k} [{label}]", {})
            products[k] = {"ms": ms, "device_us": us,
                           "gflop": flops[k] * 1e-9,
                           "tflops": flops[k] / us * 1e-6}
        bound_ms, _ = _bound_ms(
            sum(flops.values()),
            4 * (sub.numel() + shifted.numel() + tail.numel()), "highest")
        whole_ms, whole = _timed(
            lambda: w._shift(sub, prev, crossfade), iters, n_dev,
            f"middle [{label}]", dict.fromkeys(names.values(), 1))
        summary[label] = {"rows": rows_.shape[0], "products": products,
                          "middle_ms": whole_ms, "middle_device_us": whole,
                          "middle_bound_us": bound_ms * 1e3,
                          "middle_bound_share": bound_ms * 1e3 / whole}
    print(json.dumps({"middle": summary}), flush=True)
    return rows


def shard_rows(rand, raw60) -> list:
    """K1/K2 (K1t/K2t) at each tier and K4/K5 at ``highest`` on rank 0's
    band shard of Mb = 8 and 4 of the 16-band bank, at their headline
    shapes (a block of 8192 for K1/K2, 60 s for K4/K5)."""
    import torch.nn.functional as F

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    sp, pq = (StreamingPQMF(100, N_BAND, device="cuda"),
              PQMF(100, N_BAND, device="cuda"))
    Ka, Ks = sp.hkf.shape[-1], sp.hki.shape[-1]
    L = pq.params["hk_poly"].shape[-1]
    xk1 = rand(1, 1, BLOCK + Ka - 1)
    rows = []
    for Mb in (8, 4):
        w_a, w_s = sp.hkf[:Mb].contiguous(), sp.hki[:, :Mb].contiguous()
        hp_s = pq.params["hk_poly"][:Mb].contiguous()
        hi_s = pq.params["hk_ipoly"][:, :Mb].contiguous()
        w2 = pk.analysis_weights(hp_s)
        xk2 = rand(1, Mb, BLOCK // N_BAND + Ks - 1)
        x5 = rand(1, Mb, 60 * SR // N_BAND)
        for tier in ("highest",) + TIERS:
            ba = None if tier == "highest" else cc.arrange_tc_bank(
                w_a, "analysis", tier)
            bs = None if tier == "highest" else cc.arrange_tc_bank(
                w_s, "synthesis", tier)
            t = "" if tier == "highest" else "t"
            specs = [
                (f"K1{t} Mb={Mb} band shard", "analysis", xk1,
                 lambda x: cc.strided_analysis_conv(
                     x, w_a, N_BAND, mxu_precision=tier, bank=ba),
                 lambda x: cc.analysis_conv_plain(x, w_a, N_BAND,
                                                  precision=tier),
                 lambda: F.conv1d(xk1, w_a, stride=N_BAND), Ka),
                (f"K2{t} Mb={Mb} band shard", "synthesis", xk2,
                 lambda x: cc.dense_synthesis_conv(x, w_s, True, -16, tier,
                                                   bank=bs),
                 lambda x: cc.synthesis_conv_plain(x, w_s, True, -16, tier),
                 lambda: F.conv1d(xk2, w_s), Ks)]
            if tier == "highest":
                x4p, x5p = F.pad(raw60, (256, 240)), F.pad(x5, (15, 16))
                specs += [
                    (f"K4 Mb={Mb} band shard", "polyphase_analysis", raw60,
                     lambda x: pk.polyphase_analysis(x, hp_s, w2),
                     lambda x: pk.polyphase_analysis_plain(x, hp_s),
                     lambda: F.conv1d(x4p, w2, stride=N_BAND), L),
                    (f"K5 Mb={Mb} band shard", "polyphase_synthesis", x5,
                     lambda x: pk.polyphase_synthesis(x, hi_s),
                     lambda x: pk.polyphase_synthesis_plain(x, hi_s),
                     lambda: F.conv1d(x5p, hi_s), L)]
            for name, kind, x, kern, plain, lib, K in specs:
                rows.append(_row(
                    name, x, kern, plain, 20 if kind[0] == "p" else 200,
                    _work(kind, x.shape, N_BAND, K, Mb=Mb), tier,
                    _expect(kind, tier), (lib, None)))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_card(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    from pqmf_tpu_torch.cli.finetune_bank import bench_signal

    raw60 = torch.from_numpy(bench_signal(60 * SR)).to(dev)[None, None]
    rows = headline_rows(rand, raw60)
    rows += band_rows(rand, raw60)
    rows += middle_rows(rand)
    rows += shard_rows(rand, raw60)
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
