#!/usr/bin/env python3
"""Smoke run of pqmf_tpu_torch on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and ``nvcc`` and
fails without them; it never falls back to the CPU and imports no JAX.

0. Pins the CPU reference of every card-against-CPU check before torch
   loads (``CPU_PIN``: MKL's reproducible mode, ATen's AVX2 kernels) and
   prints ATen's capability.
1. Prints the card (``nvidia-smi`` name and power limit), turns TF32 off
   for cuDNN and cuBLAS, and builds the CUDA kernels from
   ``pqmf_tpu_torch/csrc`` (timed; ptxas must report no spills) and the
   native C data layer from ``pqmf_tpu_torch/native`` (timed). Holds the
   source's shared-memory gates and launch plans (``pqmf_launch_plan``)
   against their Python mirror in ``kernels/cached_conv.py``, the tier
   kernels' (``pqmf_tc_launch_plan``) too.
2. Holds each kernel — K1 analysis, K2 synthesis, K3 fused round trip, and
   the offline PQMF's polyphase adapters over them, K4/K5/K6 — against its
   plain PyTorch version on the card, at the main paths' shapes and at edge
   cases (K1 at its tile boundaries with in-kernel pads, small and large
   calls; K3 at M = 32 and 64, ``roundtrip_cluster_kernel`` (a thread-
   block cluster of M/8 blocks a tile), at host blocks of B = 1, 3, 16
   with lopsided synthesis pads and on the 60 s signal; K4-K6 at M = 4,
   16, 32, 64 and on the 60 s signal). Then the
   tensor-core tier kernels K1t/K2t/K3t of ``csrc/cached_conv_tc.cu`` (and
   K4-K6 over them) at ``bf16x3`` and ``default`` against the plain
   versions at the same tier: the same shapes; K1t/K2t at the tiles their
   plan takes +-1 for a host block and a whole file, with odd and even K,
   pads and a kept arranged bank (bit-equal to one arranged per call),
   M = 1..64 at both sizes, K = 9001, a band shard; K3t at the tiles its
   plans take +-1 at [1,1,8704], [16,1,8704], ``stream_ola``'s 215 x 4096
   and 60 s, with the analysis pad in the kernel (bit-equal to ``F.pad``
   and the call) and its kept banks (bit-equal to banks arranged per
   call); output memory NaN-filled before each call. K2's and K3's
   in-kernel pads.
3. Drives the two paths on the card, each with the launch counters zeroed
   just before and read just after:
   - the flagship (``PQMFPitchShiftWrapper``, atten 100, 16 bands,
     8192-sample blocks, 16 fixed shifts): 8 stateful blocks, one 16-stream
     step and one ``forward_fn``, each >= 90 dB against the same wrapper on
     the CPU, carried state included; one K1 + one K2 per pitch-shift step
     and one K3 per round trip; a checksum of block 0 from both sides and
     of each stage of the CPU reference's block 0; then
     the same at ``bf16x3`` and at ``default`` (K1t/K2t/K3t, plain convs
     refused) against the CPU port at the same tier, and the 60 s round
     trip at ``bf16x3`` (65.1997 dB); a diagnostic of the ``default``
     flagship with f32 DFT operands, which holds K2t on the CPU's own
     inputs against the CPU;
   - the offline path, with every plain version made to raise: ``PQMF``
     (atten 100, 16 bands) ``forward``/``inverse``/``roundtrip`` on the 60 s
     signal and a stereo batch, the fine-tuned bank, the M=32 round trip
     (one K6, as at every M),
     ``PQMFWrapper.process``, its artifact saved and reloaded, and the
     ``export_pqmf`` CLI on a 10 s wav. Each call's launches are exact, its
     output matches the CPU port, and the 60 s round trips keep the banks'
     SNRs to 0.01 dB (65.1997 dB streaming at delay 16, 55.2262 dB
     designed at delay 0, 104.2123 dB fine-tuned at ``edge_trim=1024``);
     ``PQMF`` at each tier on 60 s (55.2262 dB at ``bf16x3``); the
     committed fine-tuned M = 32 and 64 banks through
     ``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip`` on 60 s at each
     tier: one K3 (K3t) launch each and no K1/K2, equal to the CPU port at
     ``highest``, the steady-state SNR above the JAX package's floors (99 /
     98 dB; the ``default`` tier >= 45 dB);
   - the torchaudio variant (``PQMFPitchShiftWrapperTA``, 16 bands, 8192
     blocks, the reference's shift range) at B = 1 and B = 16, the 8-band x
     2048 edge case (Tb = 256) and a 10 s whole file, plain versions
     refused: one K1 and one K2 per ``pitchshifter``, each >= 90 dB against
     the CPU port; the B = 1 block at each tier;
   - ``stream_ola`` over the flagship (block 4096, overlap 2048) on 10 s,
     mono and stereo: one K1 + one K2 per block and one K3 per call, the
     pitch stream >= 90 dB and the round-trip stream within OFFLINE_TOL of
     the CPU port;
   - the standalone shifters on 10 s, each >= 90 dB against the CPU port,
     and the ``vocoder``, ``ps_torchaudio``, ``blocks`` (host loop and
     ``--scan``) and ``export_pvoc`` CLIs on a 10 s wav with
     ``--device cuda``.
3b. The ahead-of-time artifact (``export.py``): the flagship at each tier,
   ``PQMFWrapper`` and the TA wrapper (16 bands, 8192 blocks) saved with
   their ``torch.export`` program, reloaded here and in a fresh process
   that imports only ``load_stablehlo``, 8 blocks each (the flagship's tail
   carried): bit-equal to the live wrapper (<= 1e-6 fails loudly), exactly
   8 K1 + 8 K2 launches with every plain version refused, the program's
   inputs all its arguments, buffers or constants on the card; export
   seconds, program bytes, the AOT block beside the live block (CUDA
   events); and the ``export_pqmf`` / ``export_pvoc`` CLIs with
   ``--stablehlo``. On the card the reloaded program is a CUDA graph: each
   program's 8 blocks also run through ``program.eager`` (the module
   without its graph), bit-equal to the graph and the live wrapper with the
   same launches, and the three blocks (live, AOT graph, AOT eager) are
   timed by CUDA events, the host clock and ``torch.profiler`` (idle
   share).
3c. The CUDA graphs (``graphs.py``) against the eager bodies they capture,
   at each tier: the serving steps, ``stream_ola``, and ``scan_blocks``
   over 16 blocks of 8192 through a ``StreamingPQMF``'s ``process_block``
   and the flagship's graphed ``pitchshift_fn`` (bit-equal to the loop,
   16 K1 + 16 K2 a replay); capture ms and pool bytes; eager beside graph.
3d. The native C data layer (``pqmf_tpu_torch/native``, built and timed
   in phase 1): the ``blocks`` CLI's host loop runs through it and writes
   what its NumPy path writes, bit for bit.
4. Times each kernel against its plain version and, for K1/K2/K4/K5, one
   ``F.conv1d`` of the same product (``library_ms``), beside its bound
   (the larger of its FMAs at the f32 peak and its bytes at the HBM rate);
   the device time of K1-K3 at the block shapes and of K4 at 60 s from
   ``torch.profiler``, with the lone ``F.conv1d``'s device time beside K1's
   and K2's (``device_us`` / ``library_device_us`` in the kernels line);
   the flagship block, the 16-stream step, the 60 s round trips, one
   ``PQMFWrapper.process`` block, the TA block at B = 1 and 16,
   ``stream_ola`` on 10 s and the standalone shifters, with CUDA events and
   the host clock; and profiles the flagship and TA steps. The tier
   kernels at the same headline shapes against their plain versions,
   bounded at the bf16 tensor-core peak (three passes at ``bf16x3``), their
   device times, one TF32 ``F.conv1d`` computing K1t's, K2t's, K4t's and
   K5t's products (``library_ms``, its device time and error), every tier
   kernel reading its kept arranged banks, K3t's device time beside K1t +
   K2t's at [1,1,8704] and [16,1,8704] and beside K6t's and K4t + K5t's on
   60 s, the flagship block and 16-stream step at ``default`` and the 60 s
   round trips at ``bf16x3``. K3 and K3t at M = 32 and 64 on 60 s against
   their plain versions, bounded as above, their device time and events
   there and at host blocks of B = 1 and 16 beside the K1 + K2 (K1t +
   K2t) composition's, with each shape's bound and the cluster plan (one
   "K3 vs its halves" line per M and tier).

5. Fine-tuning (``parallel/training.py``) on the card: (a) one loss and
   gradient of the fine-tune loss at the committed recipe's full width (M
   = 16, 512 taps, [4, 1, 8192], seed 0) against the pinned CPU port at
   ``highest`` and ``bf16x3`` (loss within 1e-4 relative, gradient within
   1e-3 of max|g|); the graphed step (one CUDA graph, one replay a step)
   bit-equal to the eager capturable step over 50 steps at both tiers,
   the forward kept and recomputed; the step's ms and idle share, graphed
   and eager; the gap after 100 recipe steps between the card (capturable
   and plain Adam) and the CPU port; (b) the committed recipe itself, 8000
   graphed Adam steps (lr 2e-5, cosine, batch 4, length 8192, seed 0): its
   wall time, the ms per step (``utils.profiling.chained_ms``), the first
   and last loss, the
   steady-state SNR on the 60 s signal of the trained, the designed and
   the committed bank through ``StreamingPQMF.roundtrip`` (K3, one launch
   each; the trained bank >= 100 dB), the worst stopband (<= -55 dB);
   (c) a remat step against a plain one.
6. The (data, band) mesh (``parallel/sharding.py``), on the one card, so
   a correctness run and never a scaling result. Ranks spawned together:
   (a) one rank over NCCL, a (1, 1) mesh at full width (atten 100, 16
   bands, 8192 blocks): ``StreamingPQMF(mesh=)``'s round trip, ``PQMF``,
   ``PQMFWrapper.process``, the graphed ``ShardedPitchShift`` step over 8
   blocks (the band all-reduce inside the capture), the graphed TA block
   and 10 graphed data-parallel train steps, each bit-equal to the
   unsharded entry on the card; (b) two and four ranks sharing the card
   over gloo (band 2 and 4: Mb = 8 and 4), through the eager forms: the
   round trip at each tier and ``PQMF`` within K12_TOL of the unsharded
   card result, the ``ShardedPitchShift`` step >= 90 dB (the tail
   gathered from every rank), one data-parallel train step within phase
   5's tolerances, and every graphed step raising (gloo cannot be
   captured); launches and all-reduces per rank printed; (c) K1/K2
   (K1t/K2t) and K4/K5 at Mb = 8 and 4, every rank's shard, every tier,
   against their plain versions (K12_TOL), then timed at their headline
   shapes beside their plain versions, one ``F.conv1d`` and their bounds.
7. The entry points (``pqmf_tpu_torch/entry.py``): ``entry()``'s step
   (the flagship, a CUDA graph) for 3 carried steps on seeded audio blocks,
   each >= 90 dB against ``entry(device="cpu")`` with the tail, and on its
   own example input (a pure sine, ill-conditioned for the reference's
   phase rule) at ``entry.EXAMPLE_FLOOR_DB``; one K1 and one K2 a step;
   its CUDA-event ms beside the flagship block's graph on the same block,
   on the card's ``nvidia-smi`` line; ``dryrun_multichip(4)`` (4 ranks
   sharing the card over gloo, the JAX dry run's four steps); K4 and K4
   over K1t (``bf16x3``, ``default``) with ``fuse_mask=False`` against
   their plain versions (K12_TOL) at M = 4, 16, 32, 64 host blocks of B =
   1 and 16 and on 60 s; their errors join the K4 rows of the kernels line.

The last two lines are ``{"kernels": [...]}`` and ``{"ok": true, ...}``.
Any failure raises and the exit code is non-zero.
"""

from __future__ import annotations

import os

# The CPU reference of every card-against-CPU check takes one code path on
# every host: MKL in its conditional-numerical-reproducibility mode and
# ATen's AVX2 kernels, set before torch loads (MKL reads its mode at its
# first GEMM). Without them the CPU port's output moved between hosts of
# the same card (MKL dispatches by instruction set and CPU vendor).
CPU_PIN = {"MKL_CBWR": "COMPATIBLE", "ATEN_CPU_CAPABILITY": "avx2"}
os.environ.update(CPU_PIN)

import contextlib  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

SR = 44100
BLOCK = 8192
N_BAND = 16
SHIFTS16 = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
BAR_DB = 90.0
K12_TOL = dict(atol=2e-5, rtol=1e-4)  # pqmf_tpu's own kernel-vs-lax bar
K3_TOL = dict(atol=1e-5, rtol=0.0)    # recomputed halo: another tap order
K6_TOL = dict(atol=2e-5, rtol=1e-4)   # K3's order vs the polyphase formula's
OFFLINE_TOL = dict(atol=2e-5, rtol=1e-4)  # the offline path vs the CPU port
TIERS = ("bf16x3", "default")
PASSES = {"highest": 1, "bf16x3": 3, "default": 1}
# K3t/K6 at bf16x3 against their plain versions: K12_TOL. Their f32 mid is
# split again, and where it differs from the plain version's by an f32 ulp
# the lo half's rounding moves by one of its ulps (2^-17 of the mid) on
# about 2^-6 of the mids, past K3_TOL's 1e-5 on some outputs at M=2.
K3T_BF16X3_TOL = K12_TOL
# K3t/K6 at "default": the most outputs flipped mids may take past K3_TOL,
# by the bank's M. A flip moves Ks * M outputs, so the share is lumpy on a
# small call and grows with M. M <= 16 keeps its earlier bar (the most an
# NVIDIA H100 80GB HBM3 read there: 4.1%); at M = 32 and 64 each cap is
# 1.5 times the most that card read at that M over tools/k3_bands.py's
# seeds and shapes, tests/test_torch_cuda.py and this script (9.28% and
# 18.58%), rounded up to a whole percent (PERF.md)
K3T_DEFAULT_OFF = {16: 0.05, 32: 0.14, 64: 0.28}


def k3t_default_off(M: int) -> float:
    """The share of a ``default``-tier K3t's (K6's) outputs that may leave
    K3_TOL at ``M`` bands (``K3T_DEFAULT_OFF``; M <= 16 take M = 16's)."""
    return K3T_DEFAULT_OFF[max(16, M)]


# The pitch-shift paths at "default" against the CPU port: their DFT
# operands are rounded to bf16, and where the card's f32 value (cuBLAS, the
# card's atan2/cos/sin) differs from the CPU's by an f32 ulp that rounding
# flips by a bf16 ulp (2^-8 of the value). A flip on a spectral peak of a
# tonal block moves the output by ~80-90 dB (an NVIDIA H100 read 81.4-97.9
# dB on the blocks, 112-138 dB on the round trips and tails). The bar there
# is BAR_DB or, if lower, DEFAULT_MARGIN_DB under the tier's own error
# (the card's default output against its highest output of the block).
DEFAULT_MARGIN_DB = 25.0
SNR_STREAM_DB = (65.1997, 0.01)   # StreamingPQMF.roundtrip, delay 16
SNR_60S_DB = (55.2262, 0.01)      # designed M=16 bank, delay 0, whole signal
SNR_FINETUNED_DB = (104.2123, 0.01)  # fine-tuned M=16 bank, edge_trim=1024
# the JAX package's floors for the committed M = 32 / 64 banks' steady-state
# round trip (tools/tpu_checks.py, tools/gpu_checks.py)
FINETUNED_FLOOR_DB = {32: 99.0, 64: 98.0}
# and what the card read there through K3/K3t before their cluster
# redesign (PERF.md, PR 11, NVIDIA H100 80GB HBM3): the redesigned kernels
# keep each within 0.01 dB (the bf16x3 readings were kept to two decimals,
# so their bar is 0.015 dB)
FINETUNED_EARLIER_DB = {(32, "highest"): (107.4981, 0.01),
                        (64, "highest"): (104.1370, 0.01),
                        (32, "bf16x3"): (102.38, 0.015),
                        (64, "bf16x3"): (100.94, 0.015)}
# the training phase: card against the pinned CPU port (loss relative, the
# gradient against max|g|: the loss is the MSE of a residual about 1e-3 of
# the signal, so f32 summation orders show amplified), and the bars of the
# trained bank (steady-state SNR on the 60 s signal, worst stopband)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
TRAINED_SNR_DB, TRAINED_STOPBAND_DB = 100.0, -55.0
DESIGNED_STEADY_DB = (71.2761, 0.01)  # the designed bank, edge trim 512
# the committed banks' recipe (pqmf_tpu/parallel/training.py), at M = 16
RECIPE = dict(steps=8000, batch=4, length=8192, lr=2e-5,
              lr_schedule="cosine", seed=0)
TA_SHIFTS16 = [3.2, -48.5, 12.3, 0, 7, -24, 1, 2, 3, 4, 5, 6, -6, -12, 9,
               -30]                # the reference's random range
TA_SHIFTS8 = [0, -3, 5, 12, -7, 2, 1, -1]
SUB_SR = round(SR / N_BAND)        # 2756: the per-band rate
OLA_BLOCK, OLA_OVERLAP = 4096, 2048  # the block harness's defaults


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


@contextlib.contextmanager
def _plain_versions_refused():
    """Make every plain version the offline path could reach raise, so a
    run inside shows the CUDA path never took one."""
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk
    from pqmf_tpu_torch.ops import filterbank as fb

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    patched = [(pk, n) for n in ("polyphase_analysis_plain",
                                 "polyphase_synthesis_plain",
                                 "polyphase_roundtrip_plain")]
    patched += [(cc, n) for n in ("analysis_conv_plain",
                                  "synthesis_conv_plain",
                                  "roundtrip_conv_plain")]
    patched += [(fb, n) for n in ("polyphase_forward", "polyphase_inverse",
                                  "_conv1d")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in patched]
    for mod, n in patched:
        setattr(mod, n, refuse)
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def _checksum(t) -> list:
    """float64 sum and sum of |t|, as hex floats: equal lists, equal bits
    for any practical purpose."""
    t = t.detach().double()
    return [float(t.sum()).hex(), float(t.abs().sum()).hex()]


@contextlib.contextmanager
def _stage_checksums(out: dict):
    """Record, in ``out``, the checksum of each stage of the flagship's CPU
    step run inside: the sub-bands (K1's wrapper), the STFT's real and
    imaginary parts, the stretched spectrum the ISTFT takes, the ISTFT's
    overlap-add and the synthesis output (K2's wrapper). A later call on a
    host that computes the reference differently names the first stage
    that moved."""
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.ops import stft as S

    saved = {(cc, "strided_analysis_conv"): cc.strided_analysis_conv,
             (cc, "dense_synthesis_conv"): cc.dense_synthesis_conv,
             (S, "stft_ri"): S.stft_ri,
             (S, "istft_ri_parts"): S.istft_ri_parts}

    def wrap(mod, name, record):
        real = saved[mod, name]

        def fn(*args, **kwargs):
            res = real(*args, **kwargs)
            record(args, res)
            return res
        setattr(mod, name, fn)

    wrap(cc, "strided_analysis_conv",
         lambda a, r: out.setdefault("subbands", _checksum(r)))
    wrap(S, "stft_ri", lambda a, r: (out.setdefault("stft_re", _checksum(r[0])),
                                     out.setdefault("stft_im", _checksum(r[1]))))
    wrap(S, "istft_ri_parts",
         lambda a, r: (out.setdefault("stretched_re", _checksum(a[0])),
                       out.setdefault("stretched_im", _checksum(a[1])),
                       out.setdefault("istft", _checksum(r[0]))))
    wrap(cc, "dense_synthesis_conv",
         lambda a, r: out.setdefault("synthesis", _checksum(r)))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


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

    # device-side events only: a CPU op's row repeats its kernels' time,
    # and a user annotation's device row (torch.optim's
    # "Optimizer.step#Adam.step") spans kernels counted in their own rows
    rows = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / n
    return {
        "step_ms": step_ms, "profiled_step_ms": profiled_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
        "kernels_per_call": sum(e.count for e in rows) / n,
        "top_us": [[e.key[:60], dev_us(e) / n, e.count / n]
                   for e in rows[:top]],
    }


F32_FLOPS = 67e12   # H100 SXM f32 outside the tensor cores (data sheet)
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)


BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)


def _bound(name: str, x, hkf, hki, hp, precision: str = "highest") -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take for
    the headline row of kernel ``name`` on input ``x`` — the larger of its
    FMAs (2 FLOP each) at the peak of its tier (f32 at "highest"; the bf16
    tensor cores at "bf16x3", three passes, and "default", one) and the
    bytes it must move (inputs read once, output written once) at the HBM
    rate. The work is the function's own: K3's recomputed halo is not
    counted."""
    B, C, T = x.shape
    M, Ka, Ks = hkf.shape[0], hkf.shape[-1], hki.shape[-1]
    L = hp.shape[-1]
    if name == "analysis":          # [B, 1, Tpad] -> [B, M, T_out]
        t_out = (T - Ka) // M + 1
        fma, io = B * t_out * M * Ka, B * T + M * Ka + B * M * t_out
    elif name == "synthesis":       # [B, M, Tpad] -> [B, T_out, M]
        t_out = T - Ks + 1
        fma, io = B * t_out * M * M * Ks, B * M * T + M * M * Ks \
            + B * t_out * M
    elif name == "roundtrip":       # syn_pad (16, 16)
        t_ana = (T - Ka) // M + 1
        t_out = t_ana + 32 - Ks + 1
        fma = B * (t_ana * M * Ka + t_out * M * M * Ks)
        io = B * T + M * Ka + M * M * Ks + B * t_out * M
    elif name == "polyphase_analysis":   # [B, 1, T] -> [B, M, T/M]
        fma, io = B * T * M * L, 2 * B * T + M * M * L
    elif name == "polyphase_synthesis":  # [B, M, T'] -> [B, 1, M*T']
        fma, io = B * T * M * M * L, 2 * B * M * T + M * M * L
    else:                           # polyphase_roundtrip, [B, 1, T]
        fma, io = 2 * B * T * M * L, 2 * B * T + 2 * M * M * L
    peak = F32_FLOPS if precision == "highest" else BF16_FLOPS
    ops_ms = 2 * fma * PASSES[precision] / peak * 1e3
    bytes_ms = 4 * io / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def _k3t_default_close(got, ref, sub, w_syn, what: str) -> float:
    """K3t/K6 at "default" against their plain versions. The mid is
    rounded to bf16 again: where the kernel's f32 sub-band differs from the
    plain version's by an f32 ulp, that rounding can flip by one bf16 ulp
    (about 2^-15 of the mids). The tolerance follows from that bound: one
    bf16 ulp of the largest sub-band times the largest column sum of
    |w_syn| times M; and all but ``k3t_default_off(M)`` of the outputs stay
    within K3_TOL (a flip reaches Ks*M outputs). Returns that share."""
    import torch

    M = w_syn.shape[0]
    ulp = 2.0 ** (torch.floor(torch.log2(sub.abs().max())).item() - 7)
    bound = ulp * w_syn.abs().sum(dim=tuple(range(1, w_syn.ndim))).max() \
        .item() * M
    err = (got - ref).abs()
    off = (err > K3_TOL["atol"]).float().mean().item()
    assert err.max().item() <= bound + K3_TOL["atol"], (what, err.max(), bound)
    assert off <= k3t_default_off(M), (what, off, k3t_default_off(M))
    return off


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


def _device_us(fn, n: int) -> float:
    """Device time per call of ``fn`` (us): the CUDA kernels of the median
    whole call in a torch.profiler trace of 2n calls, after warm-up. A
    trace can lose kernel events (an NVIDIA H100 kept 6-9 of 10 launches
    of a 0.9 ms kernel, and none of one call) and once read a 0.16 ms
    kernel at half its time, so the calls are told apart by their kernel
    names, which repeat with the period of one call's kernels: the trace
    is read only where they do (a lost call keeps the period, a lost part
    of one breaks it), where it holds no more kernels than were launched
    and at least n whole calls survived, and the median call stands for
    all. Otherwise the trace is taken again; five such traces fail the
    run."""
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
            return per_call[calls // 2]
    raise RuntimeError(f"torch.profiler kept no {n} whole calls in 5 traces")


# the child process of the AOT phase: it imports only pqmf_tpu_torch's
# load_stablehlo (and the launch counters), no wrapper, and runs each
# program over the blocks in inputs.npz, the flagship's tail carried
_AOT_CHILD = r"""
import json, os, sys
import numpy as np, torch
from pqmf_tpu_torch.export import load_stablehlo
from pqmf_tpu_torch.kernels import cached_conv as cc
td, names, dev = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
with np.load(os.path.join(td, "inputs.npz")) as z:
    blocks = torch.from_numpy(z["blocks"]).to(dev)
counts = {}
for name in names:
    program = load_stablehlo(os.path.join(td, name), device=dev)
    cc.reset_launches()
    outs = {}
    if name.startswith("flagship"):
        with open(os.path.join(td, name, "manifest.json")) as f:
            spec = json.load(f)["state_spec"]["prev_tail"]
        tail = torch.zeros(spec, device=dev)
        ys = []
        for b in blocks:
            tail, y = program(tail, b[0])
            ys.append(y)
        outs = {"y": torch.stack(ys), "tail": tail}
    elif name == "ta":
        outs = {"y": torch.stack([program(b) for b in blocks])}
    else:
        pairs = [program(b) for b in blocks]
        outs = {"rec": torch.stack([r for r, _ in pairs]),
                "sub": torch.stack([s for _, s in pairs])}
    if dev == "cuda":
        torch.cuda.synchronize()
    counts[name] = dict(cc.LAUNCHES)
    np.savez(os.path.join(td, name + "_child.npz"),
             **{k: v.cpu().numpy() for k, v in outs.items()})
print(json.dumps(counts))
"""


def _aot_phase(card: str, dev: str = "cuda") -> dict:
    """Phase 3b: the ahead-of-time artifact on the card. The flagship of
    ``__graft_entry__.py`` at each tier, ``PQMFWrapper`` and the TA wrapper
    (16 bands, 8192 blocks) are saved with their ``torch.export`` program
    (``save_artifact(..., with_stablehlo=True)``), reloaded in this process
    and in a fresh one that imports only ``load_stablehlo``, and run over 8
    blocks (the flagship's tail carried): outputs and tail bit-equal to the
    live wrapper on the card, exactly one K1 and one K2 a block with every
    plain version refused. Prints export seconds, the program's bytes and
    graph, and the AOT block beside the live block by CUDA events; runs
    the ``--stablehlo`` CLIs. ``dev="cpu"`` rehearses it on the plain
    versions (no launches; the host clock)."""
    import torch

    from pqmf_tpu_torch import (PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, PQMFWrapper,
                                save_artifact)
    from pqmf_tpu_torch.cli import export_pqmf, export_pvoc
    from pqmf_tpu_torch.export import load_stablehlo
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.utils.audio import write_wav

    print(f"AOT artifact (torch.export programs) on {card}:")
    td = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    blocks = np.stack(np.split(_audio(8 * BLOCK, 5), 8, axis=-1))[:, None]
    np.savez(os.path.join(td, "inputs.npz"), blocks=blocks)  # [8,1,1,T]
    xs = torch.from_numpy(blocks).to(dev)
    wrappers = {f"flagship {t}": PQMFPitchShiftWrapper(
        100, N_BAND, BLOCK, SR, SHIFTS16, precision=t, device=dev)
        for t in ("highest", *TIERS)}
    wrappers["plain"] = PQMFWrapper(100, N_BAND, BLOCK, device=dev)
    wrappers["ta"] = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                             TA_SHIFTS16, device=dev)
    per_block = ({"analysis": 8, "synthesis": 8, "roundtrip": 0}
                 if dev == "cuda" else dict.fromkeys(cc.LAUNCHES, 0))

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()
    names = {k: k.replace(" ", "_") for k in wrappers}

    def live_run(w, name):
        if name.startswith("flagship"):
            state, ys = w.init_state(), []
            for b in xs:
                state, y = w.pitchshift_fn(state, b[0])
                ys.append(y)
            return {"y": torch.stack(ys), "tail": state["prev_tail"]}
        if name == "ta":
            return {"y": torch.stack([w.pitchshifter(b)
                                      for b in xs])}
        pairs = [w.process(b) for b in xs]
        return {"rec": torch.stack([r for r, _ in pairs]),
                "sub": torch.stack([s for _, s in pairs])}

    def aot_run(program, w, name):
        if name.startswith("flagship"):
            tail, ys = w.init_state()["prev_tail"], []
            for b in xs:
                tail, y = program(tail, b[0])
                ys.append(y)
            return {"y": torch.stack(ys), "tail": tail}
        if name == "ta":
            return {"y": torch.stack([program(b) for b in xs])}
        pairs = [program(b) for b in xs]
        return {"rec": torch.stack([r for r, _ in pairs]),
                "sub": torch.stack([s for _, s in pairs])}

    def events_ms(fn, n=50):
        for _ in range(5):
            fn()
        sync()
        if dev != "cuda":  # the rehearsal: the host clock
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    def max_err(got, want):
        return max((got[k] - want[k]).abs().max().item() for k in want)

    res, lives = {}, {}
    for key, w in wrappers.items():
        name, path = names[key], os.path.join(td, names[key])
        t0 = time.perf_counter()
        save_artifact(w, path, with_stablehlo=True)
        export_s = time.perf_counter() - t0
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        (method, entry), = manifest["torch_export"].items()
        assert entry == {"length": BLOCK, "device": dev}, entry
        assert "stablehlo" not in manifest
        pt2 = os.path.join(path, method + ".pt2")
        ep = torch.export.load(pt2)
        kinds = [spec.kind.name for spec in ep.graph_signature.input_specs]
        ops = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"
               and "pqmf_tpu_torch" in str(n.target)]
        assert sorted(ops) == ["pqmf_tpu_torch.analysis_conv.default",
                               "pqmf_tpu_torch.synthesis_conv.default"], ops
        consts = list(ep.constants.values()) + list(ep.state_dict.values())
        assert all(c.device.type == dev for c in consts), "a constant moved"
        program = load_stablehlo(path, device=dev)
        live = live_run(w, key)
        cc.reset_launches()
        with (_plain_versions_refused() if dev == "cuda"
              else contextlib.nullcontext()):
            got = aot_run(program, w, key)
        sync()
        launches = dict(cc.LAUNCHES)
        assert launches == per_block, (key, launches)
        # the same 8 blocks through the program without its graph
        cc.reset_launches()
        with (_plain_versions_refused() if dev == "cuda"
              else contextlib.nullcontext()):
            got_eager = aot_run(program.eager, w, key)
        sync()
        eager_launches = dict(cc.LAUNCHES)
        assert eager_launches == per_block, (key, eager_launches)
        graph_vs_eager = max_err(got, got_eager)
        assert graph_vs_eager == 0.0, (key, "AOT graph vs eager",
                                       graph_vs_eager)
        err = max(max_err(got, live), max_err(got_eager, live))
        lives[name] = live
        step = ((lambda: w.pitchshift_fn(w.init_state(), xs[0, 0]))
                if key.startswith("flagship") else
                (lambda: w.pitchshifter(xs[0])) if key == "ta" else
                (lambda: w.process(xs[0])))
        tail0 = w.init_state()["prev_tail"] if key.startswith(
            "flagship") else None
        aot_step = ((lambda: program(tail0, xs[0, 0]))
                    if key.startswith("flagship") else
                    (lambda: program(xs[0])))
        eager_fn = program.eager
        aot_eager_step = ((lambda: eager_fn(tail0, xs[0, 0]))
                          if key.startswith("flagship") else
                          (lambda: eager_fn(xs[0])))
        arms = {"live": step, "aot": aot_step, "aot_eager": aot_eager_step}
        t = {arm: [] for arm in arms}
        for arm in (*arms, *reversed(arms)):
            t[arm].append(events_ms(arms[arm]))
        t = {arm: min(v) for arm, v in t.items()}
        res[key] = {"export_s": export_s,
                    "program_bytes": os.path.getsize(pt2),
                    "inputs": {k: kinds.count(k) for k in set(kinds)},
                    "graph_nodes": len(ep.graph.nodes),
                    "launches_8_blocks": launches,
                    "launches_8_blocks_eager": eager_launches,
                    "max_abs_err_vs_live": err,
                    "graph_vs_eager_max_abs_err": graph_vs_eager,
                    "bit_equal": err == 0.0,
                    "aot_block_ms": t["aot"],
                    "aot_eager_block_ms": t["aot_eager"],
                    "live_block_ms": t["live"]}
        # the live flagship and TA blocks replay CUDA graphs on the card;
        # PQMFWrapper.process (two launches) stays eager
        live = "live (eager)" if key == "plain" else "live (graph)"
        label = {"live": live, "aot": "AOT (graph)",
                 "aot_eager": "AOT (eager)"}
        if dev == "cuda":
            # where each block's time goes: the same kernels, the idle card
            for arm, fn in arms.items():
                prof = _profile(fn, 10, t[arm], top=3)
                res[key][f"profile_{arm}"] = prof
                res[key][f"{arm}_host_ms_median_p90_n"] = _host_ms(fn, 50)
                print(f"  {key} {label[arm]} block: device busy "
                      f"{prof['device_busy_ms']:.4f} ms of {t[arm]:.4f} "
                      f"(idle {prof['idle_share']:.1%}), "
                      f"{prof['kernels_per_call']:.1f} kernels; host "
                      "median/p90 {:.4f}/{:.4f} ms".format(
                          *res[key][f"{arm}_host_ms_median_p90_n"][:2]))
        print(f"  {key}: export {export_s:.2f} s, {method}.pt2 "
              f"{os.path.getsize(pt2)} B, inputs {res[key]['inputs']}, "
              f"launches over 8 AOT blocks {launches} (graph) and "
              f"{eager_launches} (eager), max|AOT - live| {err:.3g}, graph "
              f"== eager bit for bit; block by CUDA events: AOT graph "
              f"{t['aot']:.4f} ms, AOT eager {t['aot_eager']:.4f} ms, "
              f"{live} {t['live']:.4f} ms")
        assert err <= 1e-6, (key, err)

    # a fresh process: load_stablehlo alone, no wrapper, no retrace
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _AOT_CHILD, td,
         json.dumps(list(names.values())), dev], capture_output=True,
        text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode:
        print(child.stderr[-4000:], file=sys.stderr)
    assert child.returncode == 0, child.returncode
    counts = json.loads(child.stdout.strip().splitlines()[-1])
    for key, name in names.items():
        assert counts[name] == per_block, (name, counts[name])
        with np.load(os.path.join(td, name + "_child.npz")) as z:
            got = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
        err = max_err(got, lives[name])
        res[key]["subprocess_max_abs_err"] = err
        assert err <= 1e-6, (key, err)
    worst = max(r["subprocess_max_abs_err"] for r in res.values())
    print(f"  fresh process (load_stablehlo only): {len(names)} programs, "
          f"8 blocks each, launches {counts[names['plain']]} each, max|err| "
          f"vs live {worst:.3g} ({time.perf_counter() - t0:.1f} s)")

    # the --stablehlo CLIs on a 2 s wav
    wav_in = os.path.join(td, "in.wav")
    write_wav(wav_in, _audio(2 * SR, 6) * 0.5, SR)
    for cli, method, fn in [("export_pqmf", "process", export_pqmf.main),
                            ("export_pvoc", "pitchshift", export_pvoc.main)]:
        out = os.path.join(td, cli)
        cc.reset_launches()
        rc = fn(["--input", wav_in, "--out_dir", out, "--audio_dir",
                 os.path.join(td, cli + "_audio"), "--stablehlo",
                 "--device", dev])
        sync()
        assert rc == 0 and os.path.exists(os.path.join(
            out, method + ".pt2")), (cli, rc)
        print(f"  CLI {cli} --stablehlo: exit 0, {method}.pt2 "
              f"{os.path.getsize(os.path.join(out, method + '.pt2'))} B, "
              f"launches {dict(cc.LAUNCHES)}")
    shutil.rmtree(td)
    return res


def _events_ms(fn, iters: int) -> float:
    """ms per call of ``fn`` by CUDA events over ``iters`` calls, after
    three calls of warm-up."""
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


def _host_ms(step, n: int) -> tuple:
    """Host clock per call, each ending in a synchronize: the block latency
    a real-time host sees (median, p90, n)."""
    import torch

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


def _graphs_phase(card: str) -> dict:
    """Phase 3c: the CUDA graphs (``pqmf_tpu_torch/graphs.py``) against the
    eager bodies they capture, at each tier, on fresh wrappers (16 bands,
    8192 blocks): ``pitchshift_fn`` over 8 carried blocks at B = 1 and 3
    calls at B = 16, ``pitchshift_streams`` over 4 carried 16-stream steps,
    the TA ``pitchshifter`` at B = 1 and 16 (3 calls each) and
    ``stream_ola`` (4096 / 2048) on 10 s mono and stereo. Every output (the
    carried state too) is bit-equal to the eager body's, none changes
    after a later call, and the launches are exact (one K1 + one K2 a step;
    a ``stream_ola`` replay 215 + 215 + one K3). Prints each key's capture
    and instantiate ms and pool bytes, and at ``highest`` the eager body
    beside the graph: CUDA events and the host's median/p90 of the block,
    the 16-stream step, the TA block at B = 1 and 16 and ``stream_ola``,
    and the card's idle share of the flagship and 16-stream steps."""
    import gc

    import torch

    from torch.utils._pytree import tree_leaves

    from pqmf_tpu_torch import (PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, StreamingPQMF,
                                stream_ola)
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.streaming import scan_blocks

    print(f"CUDA graphs against their eager bodies on {card}:")
    dev = torch.device("cuda")

    def on(a):
        return torch.from_numpy(a).to(dev)

    blocks = [on(b) for b in np.split(_audio(8 * BLOCK, 2), 8, axis=-1)]
    x16 = on(_audio(BLOCK, 3, batch=16))  # [16, T]
    ten = {1: on(_audio(10 * SR, 11)), 2: on(_audio(10 * SR, 12, batch=2))}
    n_ola = -(-(10 * SR - OLA_BLOCK) // (OLA_BLOCK - OLA_OVERLAP)) + 1

    def counted(fn, want):
        cc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(cc.LAUNCHES)
        assert got == {"analysis": 0, "synthesis": 0, "roundtrip": 0,
                       **want}, (want, got)
        return out

    def same(what, got, want):
        for g, e in zip(got, want):
            diff = (g - e).abs().max().item()
            assert torch.equal(g, e), f"{what}: graph - eager = {diff}"
        print(f"  {what}: graph == eager body, bit for bit")

    res = {"captures": {}, "timing": {}}
    for tier in ("highest", *TIERS):
        w = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR, SHIFTS16,
                                  precision=tier, device="cuda")
        ta = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR, TA_SHIFTS16,
                                     precision=tier, device="cuda")
        steps = 8
        se, eager = w.init_state(), []
        for b in blocks:
            se, y = w._pitchshift_fn_eager(se, b)
            eager.append(y)

        def chain(step, state, xs):
            ys = []
            for x in xs:
                state, y = step(state, x)
                ys.append(y)
            return state, ys

        sg, graph = counted(lambda: chain(w.pitchshift_fn, w.init_state(),
                                          blocks),
                            {"analysis": steps, "synthesis": steps})
        kept = [y.clone() for y in graph]
        same(f"pitchshift_fn B=1 x {steps} carried [{tier}]",
             graph + [sg["prev_tail"]], eager + [se["prev_tail"]])
        b16 = x16[:, None, :]
        _, e16 = w._pitchshift_fn_eager(w.init_state(), b16)
        g16 = counted(lambda: [w.pitchshift_fn(w.init_state(), b16)[1]
                               for _ in range(3)],
                      {"analysis": 3, "synthesis": 3})
        same(f"pitchshift_fn B=16 x 3 [{tier}]", g16, [e16] * 3)
        se, es = chain(w._pitchshift_streams_eager, w.init_streams(16),
                       [x16] * 4)
        sg, gs = counted(lambda: chain(w.pitchshift_streams,
                                       w.init_streams(16), [x16] * 4),
                         {"analysis": 4, "synthesis": 4})
        same(f"pitchshift_streams(16) x 4 carried [{tier}]",
             gs + [sg["prev_tail"]], es + [se["prev_tail"]])
        for B, x in ((1, blocks[0][None]), (16, b16)):
            want = ta._pitchshifter_eager(x)
            got = counted(lambda: [ta.pitchshifter(x) for _ in range(3)],
                          {"analysis": 3, "synthesis": 3})
            same(f"TA pitchshifter B={B} x 3 [{tier}]", got, [want] * 3)
        for C, x in ten.items():
            first = stream_ola(w, x, OLA_BLOCK, OLA_OVERLAP)
            (run,) = [r for k, r in w._stream_ola_fns.items() if k[3] == C]
            replay = counted(lambda: stream_ola(w, x, OLA_BLOCK, OLA_OVERLAP),
                             {"analysis": n_ola, "synthesis": n_ola,
                              "roundtrip": 1})
            same(f"stream_ola C={C} 10 s [{tier}]", list(replay),
                 list(run.fn(x)))
            same(f"stream_ola C={C} first call (eager) [{tier}]",
                 list(first), list(replay))
        # scan_blocks: one graph a pre-framed stream of 16 blocks of 8192,
        # over a StreamingPQMF's process_block and over the flagship's
        # graphed pitchshift_fn (its eager body runs inside the capture)
        sp = StreamingPQMF(100, N_BAND, precision=tier, device="cuda")
        x_scan = on(_audio(16 * BLOCK, 15)).reshape(16, 1, 1, BLOCK)
        for what, step_fn, body, s0, xs_ in (
                ("StreamingPQMF.process_block", sp.process_block,
                 sp.process_block, sp.init_state(), x_scan),
                ("flagship pitchshift_fn", w.pitchshift_fn,
                 w._pitchshift_fn_eager, w.init_state(), x_scan[:, 0])):
            state, loop = s0, []
            for b in xs_:
                state, y = body(state, b)
                loop.append(y)
            first = scan_blocks(step_fn, s0, xs_)
            ts, ys = counted(lambda: scan_blocks(step_fn, s0, xs_),
                             {"analysis": 16, "synthesis": 16})
            same(f"scan_blocks over {what} 16 x 8192 [{tier}]",
                 [ys, first[1], *tree_leaves(ts), *tree_leaves(first[0])],
                 [torch.stack(loop)] * 2 + tree_leaves(state) * 2)
        caps = {f"{k[0]} B={k[1]} T={k[2]}": p.stats
                for k, p in (*w._graphs.items(), *ta._graphs.items())
                if k[0] != "scan_blocks"}
        caps.update({f"scan_blocks over {k[1]} n={k[2]} block {k[3]}":
                     p.stats for k, p in (*w._graphs.items(),
                                          *sp._graphs.items())
                     if k[0] == "scan_blocks"})
        caps.update({f"stream_ola C={k[3]} T={k[2]}": p.stats
                     for k, p in w._stream_ola_fns.items()})
        res["captures"][tier] = caps
        for what, st in caps.items():
            print(f"  capture {what} [{tier}]: {st['capture_ms']:.1f} ms, "
                  f"instantiate {st['instantiate_ms']:.1f} ms, pool "
                  f"{st['pool_bytes']} B, outputs {st['output_bytes']} B")

        # the eager body beside the graph: CUDA events (ms a call) and the
        # host clock (median, p90, n), state carried
        st = {"e": w.init_state(), "g": w.init_state(),
              "es": w.init_streams(16), "gs": w.init_streams(16)}

        def block_e():
            st["e"], _ = w._pitchshift_fn_eager(st["e"], blocks[1])

        def block_g():
            st["g"], _ = w.pitchshift_fn(st["g"], blocks[1])

        def streams_e():
            st["es"], _ = w._pitchshift_streams_eager(st["es"], x16)

        def streams_g():
            st["gs"], _ = w.pitchshift_streams(st["gs"], x16)

        arms = {"flagship block": (block_e, block_g, 50, 100),
                "16-stream step": (streams_e, streams_g, 30, 100)}
        if tier == "highest":
            arms.update({
                "TA block B=1": (lambda: ta._pitchshifter_eager(blocks[0][None]),
                                 lambda: ta.pitchshifter(blocks[0][None]),
                                 50, 100),
                "TA blocks B=16": (lambda: ta._pitchshifter_eager(b16),
                                   lambda: ta.pitchshifter(b16), 30, 50)})
            for C, x in ten.items():
                (run,) = [r for k, r in w._stream_ola_fns.items()
                          if k[3] == C]
                arms[f"stream_ola C={C} 10 s"] = (
                    lambda run=run, x=x: run.fn(x),
                    lambda x=x: stream_ola(w, x, OLA_BLOCK, OLA_OVERLAP),
                    None, 5 if C == 1 else 3)
            s16 = w.init_state()

            def scan_eager():
                state = s16
                for b in x_scan[:, 0]:
                    state, _ = w._pitchshift_fn_eager(state, b)

            arms["scan_blocks 16 x 8192 (flagship)"] = (
                scan_eager,
                lambda: scan_blocks(w.pitchshift_fn, s16, x_scan[:, 0]),
                5, 10)
        timing = {}
        for what, (eager_fn, graph_fn, iters, n) in arms.items():
            row = {}
            for arm, fn in (("eager", eager_fn), ("graph", graph_fn),
                            ("eager", eager_fn), ("graph", graph_fn)):
                ms = _events_ms(fn, iters) if iters else None
                row.setdefault(f"{arm}_events_ms", []).append(ms)
            for arm, fn in (("eager", eager_fn), ("graph", graph_fn)):
                row[f"{arm}_host_ms_median_p90_n"] = _host_ms(fn, n)
            if tier == "highest" and what in ("flagship block",
                                              "16-stream step"):
                for arm, fn in (("eager", eager_fn), ("graph", graph_fn)):
                    ms = min(row[f"{arm}_events_ms"])
                    prof = _profile(fn, 10, ms, top=3)
                    row[f"{arm}_profile"] = prof
            timing[what] = row
            ev = row["eager_events_ms"]
            txt = ("" if ev[0] is None else
                   f"events eager {min(ev):.4f} ms, graph "
                   f"{min(row['graph_events_ms']):.4f} ms; ")
            he, hg = (row[f"{a}_host_ms_median_p90_n"]
                      for a in ("eager", "graph"))
            txt += (f"host median/p90 eager {he[0]:.4f}/{he[1]:.4f} ms, "
                    f"graph {hg[0]:.4f}/{hg[1]:.4f} ms")
            for arm in ("eager", "graph"):
                prof = row.get(f"{arm}_profile")
                if prof:
                    txt += (f"; {arm} busy {prof['device_busy_ms']:.4f} ms, "
                            f"idle {prof['idle_share']:.1%}, "
                            f"{prof['kernels_per_call']:.1f} kernels")
            print(f"  {what} [{tier}]: {txt}")
        res["timing"][tier] = timing
        del w, ta, run, sp
        gc.collect()
    return res


def _training_phase(sixty: np.ndarray, card: str) -> dict:
    """Phase 5: fine-tuning on the card (see the module docstring)."""
    import torch

    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.ops import filterbank as fb_ops
    from pqmf_tpu_torch.parallel import training as tt
    from pqmf_tpu_torch.utils.profiling import chained_ms

    out = {"card": card}
    hk = fb_ops.build_filterbank(100, N_BAND)["hk"]
    x = np.random.default_rng(0).standard_normal((4, 1, 8192)).astype(
        np.float32)
    loss_fn = tt.make_finetune_loss(N_BAND, hk.shape[-1])
    for tier in ("highest", "bf16x3"):
        lc, gc = tt.loss_and_grad(loss_fn, torch.from_numpy(hk),
                                  torch.from_numpy(x), tier)
        lg, gg = tt.loss_and_grad(loss_fn, torch.from_numpy(hk).cuda(),
                                  torch.from_numpy(x).cuda(), tier)
        rel = abs(lg.item() - lc.item()) / lc.item()
        gerr = ((gg.cpu() - gc).abs().max() / gc.abs().max()).item()
        print(f"  fine-tune loss and gradient at {tier}, card vs CPU: loss "
              f"{lg.item():.6e} vs {lc.item():.6e} (rel {rel:.2e}), "
              f"max|dg| / max|g| {gerr:.2e}")
        assert rel <= TRAIN_LOSS_RTOL and gerr <= TRAIN_GRAD_RTOL, (tier, rel,
                                                                    gerr)
        out[f"grad_parity_{tier}"] = {"loss_rel": rel, "grad_rel": gerr}

    # the graphed step (one CUDA graph a step) against the eager step it
    # captures, the same capturable Adam: 50 steps of the recipe's loss and
    # shapes, cosine lr, at each tier, the forward kept or recomputed
    xs50 = [torch.from_numpy(a).cuda() for a in np.random.default_rng(
        1).standard_normal((50, 4, 1, 8192)).astype(np.float32)]
    for tier in ("highest", "bf16x3"):
        for remat in (False, True):
            init, step = tt.make_train_step(
                tt.adam(tt.cosine_decay_schedule(2e-5, 50)), precision=tier,
                remat=remat, loss_fn=loss_fn)
            sg, se = init(hk), init(hk)
            lg, le, replays = [], [], [0]
            for i, xb in enumerate(xs50):
                lg.append(step(sg, xb)[1])
                le.append(step.eager(se, xb)[1])
                if i == 0:  # count the replays from here on
                    (prog,) = sg._graphs.values()
                    replay = prog._replay

                    def counted_replay(replay=replay):
                        replays[0] += 1
                        replay()
                    prog._replay = counted_replay
            torch.cuda.synchronize()
            ma, mb = sg.optimizer.state[sg.hk], se.optimizer.state[se.hk]
            pairs = [(torch.stack(lg), torch.stack(le)), (sg.hk, se.hk),
                     *((ma[k], mb[k]) for k in ("exp_avg", "exp_avg_sq",
                                                "step"))]
            diff = max((a - b).abs().max().item() for a, b in pairs)
            print(f"  train step [{tier}, remat={remat}]: 50 graphed steps "
                  f"(one capture, {replays[0]} replays) vs 50 eager "
                  f"capturable steps: max|diff| {diff:.3g} (losses, hk, "
                  f"Adam's moments and count); capture "
                  f"{prog.stats['capture_ms']:.1f} ms, instantiate "
                  f"{prog.stats['instantiate_ms']:.1f} ms, pool "
                  f"{prog.stats['pool_bytes']} B")
            assert replays[0] == 49, replays
            assert all(torch.equal(a, b) for a, b in pairs), (tier, remat,
                                                              diff)
            out[f"graph_vs_eager_{tier}_remat_{remat}"] = {
                "max_abs_diff": diff, "replays": replays[0],
                "capture": prog.stats}

    cc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = tt.finetune_filterbank(100, N_BAND, **RECIPE)
    wall = time.perf_counter() - t0
    train_launches = dict(cc.LAUNCHES)
    assert losses.shape == (RECIPE["steps"],) and np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    init, step = tt.make_train_step(tt.adam(2e-5), loss_fn=loss_fn)
    xd = torch.from_numpy(x).cuda()
    arms = {}
    for arm, fn in (("graph", step), ("eager", step.eager)):
        state = init(hk)
        ms = chained_ms(lambda v, fn=fn, state=state: (fn(state, v), v)[1],
                        xd, n=100)
        prof = _profile(lambda fn=fn, state=state: fn(state, xd), 10, ms)
        arms[arm] = {"events_ms": ms, "profile": prof,
                     "host_ms_median_p90_n": _host_ms(
                         lambda fn=fn, state=state: fn(state, xd), 50)}
        print(json.dumps({"profile": f"train step ({arm})", **prof}))
    step_ms, profile = arms["graph"]["events_ms"], arms["graph"]["profile"]
    for arm, r in arms.items():
        print(f"  train step ({arm}): {r['events_ms']:.4f} ms (chained_ms, "
              f"CUDA events), host median/p90 "
              f"{r['host_ms_median_p90_n'][0]:.4f}/"
              f"{r['host_ms_median_p90_n'][1]:.4f} ms, device busy "
              f"{r['profile']['device_busy_ms']:.4f} ms (idle "
              f"{r['profile']['idle_share']:.1%}), "
              f"{r['profile']['kernels_per_call']:.1f} kernels")

    # capturable Adam on the card against the CPU port's plain Adam after
    # 100 recipe steps, beside the card's plain (non-capturable) Adam run
    # eagerly: the gap is measured here, not assumed
    short = dict(RECIPE, steps=100)
    p_card, l_card = tt.finetune_filterbank(100, N_BAND, **short)
    p_cpu, l_cpu = tt.finetune_filterbank(100, N_BAND, device="cpu", **short)
    sched = tt.cosine_decay_schedule(short["lr"], short["steps"])

    def plain_adam(t):
        return torch.optim.Adam([t], lr=sched(0), betas=(0.9, 0.999),
                                eps=1e-8)
    plain_adam.schedule = sched
    init, step = tt.make_train_step(plain_adam, loss_fn=loss_fn)
    state = init(hk)
    l_plain = torch.stack([step.eager(state, xb)[1] for xb in
                           tt.noise_batches(0, 100, 4, 8192, "cuda")])
    hk_plain = state.hk.detach().cpu().numpy()
    scale = np.abs(p_cpu["hk"]).max()
    gap = {
        "capturable_vs_cpu_hk": float(np.abs(p_card["hk"] - p_cpu["hk"])
                                      .max() / scale),
        "plain_vs_cpu_hk": float(np.abs(hk_plain - p_cpu["hk"]).max()
                                 / scale),
        "capturable_vs_plain_hk": float(np.abs(p_card["hk"] - hk_plain)
                                        .max() / scale),
        "capturable_vs_cpu_loss": float(np.max(np.abs(l_card - l_cpu)
                                               / l_cpu)),
        "plain_vs_cpu_loss": float(np.max(np.abs(
            l_plain.cpu().numpy() - l_cpu) / l_cpu))}
    print(f"  100 recipe steps, card vs the CPU port: max|dhk|/max|hk| "
          f"capturable {gap['capturable_vs_cpu_hk']:.3g}, plain Adam "
          f"{gap['plain_vs_cpu_hk']:.3g} (capturable vs plain "
          f"{gap['capturable_vs_plain_hk']:.3g}); worst loss rel "
          f"capturable {gap['capturable_vs_cpu_loss']:.3g}, plain "
          f"{gap['plain_vs_cpu_loss']:.3g}")
    out["adam_gap_100_steps"] = gap
    cc.reset_launches()
    snr = {name: tt.roundtrip_snr(p, 100, N_BAND, sixty)
           for name, p in [("designed", None),
                           ("committed", tt.load_pretrained_bank()),
                           ("trained", params)]}
    readout_launches = dict(cc.LAUNCHES)
    stopband = {"trained": tt.worst_stopband_db(params["hk"]),
                "committed": tt.worst_stopband_db(
                    tt.load_pretrained_bank()["hk"])}
    print(f"  recipe {RECIPE} (graphed): {wall:.2f} s wall, {step_ms:.4f} "
          f"ms a step (chained_ms, CUDA events), loss {losses[0]:.4e} -> "
          f"{losses[-1]:.4e}; launches while training {train_launches}")
    print(f"  steady-state SNR on the 60 s signal (K3, edge trim 512): "
          f"trained {snr['trained']:.4f} dB, designed {snr['designed']:.4f} "
          f"dB, committed {snr['committed']:.4f} dB; worst stopband trained "
          f"{stopband['trained']:.2f} dB, committed "
          f"{stopband['committed']:.2f} dB; readout launches "
          f"{readout_launches}")
    assert readout_launches == {"analysis": 0, "synthesis": 0,
                                "roundtrip": 3}, readout_launches
    assert all(v == 0 for v in train_launches.values()), train_launches
    assert snr["trained"] >= TRAINED_SNR_DB, snr
    assert stopband["trained"] <= TRAINED_STOPBAND_DB, stopband
    assert abs(snr["designed"] - DESIGNED_STEADY_DB[0]) \
        <= DESIGNED_STEADY_DB[1], snr
    assert snr["committed"] >= TRAINED_SNR_DB, snr

    # a step with the loss recomputed in the backward equals a plain step
    # (the JAX package's remat test, on the card)
    hk4 = fb_ops.build_filterbank(70, 4)["hk"]
    x4 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 1, 256)).astype(np.float32)).cuda()
    res = []
    for remat in (False, True):
        init, step = tt.make_train_step(remat=remat)
        res.append(step(init(hk4), x4))
    dl = abs(res[0][1].item() - res[1][1].item())
    dhk = (res[0][0].hk - res[1][0].hk).abs().max().item()
    print(f"  remat step vs plain step: |dloss| {dl:.3g}, max|dhk| {dhk:.3g}")
    assert dl < 1e-7 and dhk <= 1e-7, (dl, dhk)
    out.update({
        "recipe": RECIPE, "recipe_wall_s": wall, "train_step_ms": step_ms,
        "train_step_device_busy_ms": profile["device_busy_ms"],
        "train_step_idle_share": profile["idle_share"],
        "train_step_arms": arms,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "steady_snr_db_60s": snr, "worst_stopband_db": stopband,
        "k3_launches_readout": readout_launches["roundtrip"],
        "launches_training": train_launches, "remat_dloss": dl,
        "remat_dhk": dhk})
    return out


def _native_phase(card: str, dev: str = "cuda") -> dict:
    """Phase 3d: the native C data layer (``pqmf_tpu_torch/native``) on the
    card's machine, built from the checkout's source into
    ``pqmf_tpu_torch/_build/`` (phase 1): the ``blocks`` CLI's host loop
    (10 s, 4096 / 2048, the flagship on the card) reads its wav,
    overlap-adds every block and writes its three wavs through it
    (``native.CALLS``); the same run with the library withheld (the NumPy
    path) writes the same arrays and files bit for bit (its samples lie in
    [-1, 1]); and the library's encoder, decoders and OLA equal the NumPy
    forms on in-range samples.
    ``dev="cpu"`` rehearses it with the CLI on the CPU."""
    import torch

    from pqmf_tpu_torch import native
    from pqmf_tpu_torch.cli import blocks as blocks_cli
    from pqmf_tpu_torch.utils import audio

    print(f"native data layer on the machine of {card}:")
    path, lib = native.build(), native.get()  # built in phase 1
    assert path is not None and lib is not None, "the C library did not build"
    print(f"  library: {path.relative_to(path.parents[2])}")
    td = tempfile.mkdtemp(prefix="chip_smoke_native_")
    wav = os.path.join(td, "in.wav")
    audio.write_wav(wav, _audio(10 * SR, 14) * 0.5, SR)
    n_frames = -(-(10 * SR - OLA_BLOCK) // (OLA_BLOCK - OLA_OVERLAP)) + 1
    written, calls, arm = {}, {}, [None]
    real_write, real_get, real_native = (audio.write_wav, native.get,
                                         audio._native)

    def capture(p, x, sr, subtype="PCM_16"):
        written.setdefault(arm[0], {})[os.path.basename(p)] = np.array(x)
        real_write(p, x, sr, subtype)

    audio.write_wav = capture
    try:
        for arm[0] in ("C", "NumPy"):
            if arm[0] == "NumPy":
                native.get = audio._native = lambda: None
            native.CALLS.clear()
            rc = blocks_cli.main([
                wav, "--out_dir", os.path.join(td, arm[0]), "--block",
                str(OLA_BLOCK), "--overlap", str(OLA_OVERLAP), "--shifts",
                ",".join(str(v) for v in SHIFTS16), "--device", dev])
            if dev == "cuda":
                torch.cuda.synchronize()
            assert rc == 0, (arm[0], rc)
            calls[arm[0]] = dict(native.CALLS)
    finally:
        audio.write_wav, native.get, audio._native = (real_write, real_get,
                                                      real_native)
    want = {"pcm16_to_f32": 1, "ola_accumulate": 2 * n_frames,
            "f32_to_pcm16": 3}
    assert calls == {"C": want, "NumPy": {}}, calls
    peak = 0.0
    for name, a in written["C"].items():
        b = written["NumPy"][name]
        assert a.shape == b.shape == (1, 10 * SR) and np.array_equal(a, b), \
            name
        peak = max(peak, float(np.abs(a).max()))
        with open(os.path.join(td, "C", name), "rb") as f, \
                open(os.path.join(td, "NumPy", name), "rb") as g:
            assert f.read() == g.read(), name
    print(f"  blocks CLI host loop ({n_frames} blocks): library calls "
          f"{calls['C']}; the NumPy run (library withheld) wrote the same "
          f"{len(written['C'])} arrays and files bit for bit (peak "
          f"{peak:.3f})")
    # the library against the NumPy forms on in-range samples
    rng = np.random.default_rng(16)
    x = rng.uniform(-1.0, 1.0, 1 << 20).astype(np.float32)
    pcm = lib.f32_to_pcm16(x)
    assert np.array_equal(
        pcm, (np.clip(x, -1.0, 1.0) * 32767.0).round().astype("<i2"))
    assert np.array_equal(lib.pcm16_to_f32(pcm.tobytes()),
                          pcm.astype(np.float32) / 32768.0)
    acc, nrm = np.zeros(1 << 16, np.float32), np.zeros(1 << 16, np.float32)
    acc_np, nrm_np = acc.copy(), nrm.copy()
    win = x[:OLA_BLOCK] ** 2
    for i in range(0, acc.size - OLA_BLOCK + 1, OLA_BLOCK - OLA_OVERLAP):
        blk = x[i:i + OLA_BLOCK]
        lib.ola_accumulate(acc, nrm, blk, win, i)
        acc_np[i:i + OLA_BLOCK] += blk * win
        nrm_np[i:i + OLA_BLOCK] += win * win
    assert np.array_equal(acc, acc_np) and np.array_equal(nrm, nrm_np)
    print("  encoder, decoder and OLA == NumPy on 2^20 in-range samples")
    shutil.rmtree(td)
    return {"library": path.name, "calls": calls["C"],
            "cli_bit_equal": True, "peak": peak}


# -- 6. the (data, band) mesh -------------------------------------------------
#
# Three runs of ranks spawned on the one card (one card can show correctness,
# never multi-card scaling): "nccl_1x1", a (1, 1) mesh over NCCL whose graphs
# hold the band and gradient all-reduces; "gloo_1x2" and "gloo_1x4", two and
# four ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one card),
# band 2 and 4 (Mb = 8 and 4), through the steps' eager forms (gloo cannot be
# captured; the graphs must raise there).

MESH_RUNS = {"nccl_1x1": ("nccl", 1), "gloo_1x2": ("gloo", 2),
             "gloo_1x4": ("gloo", 4)}
MESH_TIMEOUT = 420  # seconds for all three runs, started together


def _mesh_rank(rank: int, world: int, init: str, backend: str, which: str,
               out_dir: str, dev: str = "cuda") -> None:
    """One rank of a mesh run: writes ``<which>_<rank>.json`` (its checks,
    errors, launches and collectives) or ``.err`` (its traceback).
    ``dev="cpu"`` rehearses it on the plain versions over gloo."""
    import traceback

    import torch
    import torch.distributed as dist

    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend if dev == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world)
    try:
        res = (_mesh_nccl(dev) if backend == "nccl"
               else _mesh_gloo(rank, world, dev))
        with open(os.path.join(out_dir, f"{which}_{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{which}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _mesh_counts() -> dict:
    """The kernels' launches and the collectives since the last reset."""
    from pqmf_tpu_torch import graphs
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    return {**{f"K{i + 1}": cc.LAUNCHES[k] for i, k in enumerate(
        ("analysis", "synthesis", "roundtrip"))},
            **{f"K{i + 4}": pk.LAUNCHES[k] for i, k in enumerate(
                ("analysis", "synthesis", "roundtrip"))},
            **graphs.COLLECTIVES}


def _mesh_reset() -> None:
    from pqmf_tpu_torch import graphs
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    cc.reset_launches()
    pk.reset_launches()
    graphs.reset_collectives()


def _mesh_nccl(dev: str = "cuda") -> dict:
    """(a) A (1, 1) mesh over NCCL at full width (atten 100, 16 bands,
    8192-sample blocks): every entry through the mesh is bit-equal to the
    unsharded entry on the card, the steps' CUDA graphs included (the band
    all-reduce and the gradient all-reduce inside the capture)."""
    import torch

    from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, PQMFWrapper,
                                StreamingPQMF)
    from pqmf_tpu_torch.ops import filterbank as fb_ops
    from pqmf_tpu_torch.parallel import training as tt
    from pqmf_tpu_torch.parallel.sharding import ShardedPitchShift, make_mesh

    mesh = make_mesh(1, n_band=N_BAND, device_type=dev)
    assert tuple(mesh.shape) == (1, 1), mesh.shape
    res = {"checks": {}, "launches": {}}
    on = {"device": dev}

    def equal(what, got, want):
        got = got.to_local() if hasattr(got, "to_local") else got
        want = want.to_local() if hasattr(want, "to_local") else want
        assert got.shape == want.shape, (what, got.shape, want.shape)
        assert torch.isfinite(got).all(), what
        err = (got - want).abs().max().item()
        assert torch.equal(got, want), (what, err)
        res["checks"][what] = err

    x = torch.from_numpy(_audio(8 * BLOCK, 21)[None]).to(dev)  # [1,1,8T]
    sp, spu = (StreamingPQMF(100, N_BAND, mesh=mesh, **on),
               StreamingPQMF(100, N_BAND, **on))
    _mesh_reset()
    y = sp.roundtrip(x)
    res["launches"]["StreamingPQMF.roundtrip"] = _mesh_counts()
    equal("StreamingPQMF(mesh).roundtrip == unsharded K1+K2", y,
          spu.inverse(spu.forward(x)))
    k3 = (y.to_local() - spu.roundtrip(x)).abs().max().item()
    assert k3 <= K3_TOL["atol"], k3
    res["checks"]["StreamingPQMF(mesh).roundtrip vs unsharded K3"] = k3
    pq, pqu = PQMF(100, N_BAND, mesh=mesh, **on), PQMF(100, N_BAND, **on)
    _mesh_reset()
    sub = pq.forward(x)
    rec = pq.inverse(sub)
    rt = pq.roundtrip(x)
    res["launches"]["PQMF forward, inverse, roundtrip"] = _mesh_counts()
    equal("PQMF(mesh).forward", sub, pqu.forward(x))
    equal("PQMF(mesh).inverse", rec, pqu.inverse(pqu.forward(x)))
    equal("PQMF(mesh).roundtrip == K4+K5", rt, pqu.inverse(pqu.forward(x)))
    blk = x[..., :BLOCK]
    wr, wru = (PQMFWrapper(100, N_BAND, mesh=mesh, **on),
               PQMFWrapper(100, N_BAND, **on))
    _mesh_reset()
    r_m, s_m = wr.process(blk)
    res["launches"]["PQMFWrapper.process"] = _mesh_counts()
    r_u, s_u = wru.process(blk)
    equal("PQMFWrapper(mesh).process rec", r_m, r_u)
    equal("PQMFWrapper(mesh).process sub", s_m, s_u)

    # the graphed ShardedPitchShift step: 8 blocks, the tail carried
    w = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR,
                              shifts_in_semitones=SHIFTS16, **on)
    sh = ShardedPitchShift(w, mesh)
    blocks = torch.from_numpy(_audio(8 * BLOCK, 22)).to(dev).reshape(
        8, 1, 1, BLOCK)
    _mesh_reset()
    tail, ys = sh.init_state(), []
    for b in blocks:
        tail, yb = sh(tail, b)
        ys.append(yb.to_local())
    res["launches"]["ShardedPitchShift x8 (graph)"] = _mesh_counts()
    if dev == "cuda":
        prog = next(iter(sh.wrapper._graphs.values()))
        res["sharded_step_graph"] = {
            "collectives_a_replay": prog.collectives,
            "launches_a_replay": prog.launches, "capture": prog.stats}
    st, ys_u = w.init_state(), []
    for b in blocks:
        st, yb = w.pitchshift_fn(st, b)
        ys_u.append(yb)
    equal("ShardedPitchShift (graph) y x8", torch.stack(ys),
          torch.stack(ys_u))
    equal("ShardedPitchShift (graph) tail", tail, st["prev_tail"])
    te, ye = sh.eager(sh.init_state(), blocks[0])
    equal("ShardedPitchShift eager == graph", ye, ys[0])
    if dev == "cuda":
        res["times_ms"] = {
            "sharded_step_graph": _events_ms(lambda: sh(tail, blocks[1]),
                                             100),
            "unsharded_step_graph": _events_ms(
                lambda: w.pitchshift_fn(st, blocks[1]), 100)}

    # the TA block through the wrapper's mesh, graphed
    ta = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                 shifts_in_semitones=TA_SHIFTS16, mesh=mesh,
                                 **on)
    tau = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                  shifts_in_semitones=TA_SHIFTS16, **on)
    _mesh_reset()
    y_ta = [ta.pitchshifter(blocks[i]) for i in range(3)]
    res["launches"]["TA pitchshifter x3 (graph)"] = _mesh_counts()
    for i in range(3):
        equal(f"TA(mesh) block {i}", y_ta[i], tau.pitchshifter(blocks[i]))

    # the graphed data-parallel train step over 10 steps
    hk = fb_ops.build_filterbank(100, N_BAND)["hk"]
    loss_fn = tt.make_finetune_loss(N_BAND, hk.shape[-1])
    xs = [torch.from_numpy(a).to(dev) for a in np.random.default_rng(
        3).standard_normal((10, 4, 1, 8192)).astype(np.float32)]
    init_m, step_m = tt.make_train_step(tt.adam(2e-5), mesh=mesh,
                                        loss_fn=loss_fn, **on)
    init_u, step_u = tt.make_train_step(tt.adam(2e-5), loss_fn=loss_fn,
                                        **on)
    sm, su = init_m(hk), init_u(hk)
    _mesh_reset()
    lm = [step_m(sm, xb)[1] for xb in xs]
    res["launches"]["train step x10 (graph)"] = _mesh_counts()
    lu = [step_u(su, xb)[1] for xb in xs]
    equal("train step (mesh, graph) losses x10", torch.stack(lm),
          torch.stack(lu))
    equal("train step (mesh, graph) hk", sm.hk, su.hk)
    return res


def _mesh_gloo(rank: int, world: int, dev: str = "cuda") -> dict:
    """(b) ``world`` ranks sharing the card over gloo, band = world: the
    eager forms against the unsharded entries on the card (K12_TOL, >= 90
    dB, the training phase's tolerances), the graphs refused."""
    import torch
    import torch.distributed as dist

    from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, StreamingPQMF)
    from pqmf_tpu_torch.ops import filterbank as fb_ops
    from pqmf_tpu_torch.parallel import training as tt
    from pqmf_tpu_torch.parallel.sharding import ShardedPitchShift, make_mesh
    from pqmf_tpu_torch.utils.metrics import snr_db

    mesh = make_mesh(world, n_band=N_BAND, device_type=dev)
    assert tuple(mesh.shape) == (1, world), mesh.shape
    Mb = N_BAND // world
    sl = slice(rank * Mb, (rank + 1) * Mb)
    res = {"Mb": Mb, "checks": {}, "launches": {}}
    on = {"device": dev}

    def graph_refused(fn, what):
        """On the card a graphed step over gloo raises; on the CPU nothing
        is captured and it runs."""
        if dev != "cuda":
            return
        try:
            fn()
        except RuntimeError as e:
            assert "NCCL only" in str(e), e
            return
        raise AssertionError(f"a graphed {what} over gloo ran")

    def close(what, got, want, tol=K12_TOL):
        got = got.to_local() if hasattr(got, "to_local") else got
        assert got.shape == want.shape, (what, got.shape, want.shape)
        assert torch.isfinite(got).all(), what
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{what}: {m}")
        res["checks"][what] = (got - want).abs().max().item()

    x = torch.from_numpy(_audio(8 * BLOCK, 21)[None]).to(dev)
    for tier in ("highest", "bf16x3", "default"):
        sp = StreamingPQMF(100, N_BAND, precision=tier, mesh=mesh, **on)
        spu = StreamingPQMF(100, N_BAND, precision=tier, **on)
        assert sp.hkf_shard.shape[0] == Mb and sp.hki_shard.shape[1] == Mb
        _mesh_reset()
        sub = sp.forward(x)
        y = sp.roundtrip(x)
        res["launches"][f"StreamingPQMF forward + roundtrip [{tier}]"] = \
            _mesh_counts()
        sub_u = spu.forward(x)
        close(f"StreamingPQMF(mesh).forward band shard [{tier}]", sub,
              sub_u[:, sl])
        close(f"StreamingPQMF(mesh).roundtrip [{tier}]", y,
              spu.inverse(sub_u))
    pq, pqu = PQMF(100, N_BAND, mesh=mesh, **on), PQMF(100, N_BAND, **on)
    _mesh_reset()
    sub = pq.forward(x)
    rec = pq.inverse(sub)
    res["launches"]["PQMF forward + inverse"] = _mesh_counts()
    sub_u = pqu.forward(x)
    close("PQMF(mesh).forward band shard", sub, sub_u[:, sl])
    close("PQMF(mesh).inverse", rec, pqu.inverse(sub_u))

    w = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR,
                              shifts_in_semitones=SHIFTS16, **on)
    sh = ShardedPitchShift(w, mesh)
    blocks = torch.from_numpy(_audio(8 * BLOCK, 22)).to(dev).reshape(
        8, 1, 1, BLOCK)
    graph_refused(lambda: sh(sh.init_state(), blocks[0]),
                  "ShardedPitchShift step")
    _mesh_reset()
    tail, ys = sh.init_state(), []
    for b in blocks:
        tail, yb = sh.eager(tail, b)
        ys.append(yb.to_local())
    res["launches"]["ShardedPitchShift.eager x8"] = _mesh_counts()
    st, ys_u = w.init_state(), []
    for b in blocks:
        st, yb = w.pitchshift_fn(st, b)
        ys_u.append(yb)
    db = min(snr_db(ys_u[i].cpu().numpy(), ys[i].cpu().numpy())
             for i in range(8))
    # the whole tail from every rank's bands (gloo gathers CPU copies; a
    # shard of near-silent bands alone has no meaningful dB)
    parts = [torch.empty((Mb, w.band_overlap)) for _ in range(world)]
    dist.all_gather(parts, tail.to_local().cpu())
    tail_db = snr_db(st["prev_tail"].cpu().numpy(),
                     torch.cat(parts).numpy())
    assert db >= BAR_DB and tail_db >= BAR_DB, (db, tail_db)
    res["checks"]["ShardedPitchShift.eager y x8, min dB"] = db
    res["checks"]["ShardedPitchShift.eager tail dB"] = tail_db
    ta = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                 shifts_in_semitones=TA_SHIFTS16, mesh=mesh,
                                 **on)
    graph_refused(lambda: ta.pitchshifter(blocks[0]), "TA block")

    if world == 2:  # one data-parallel step, batch 4 over 2 ranks
        hk = fb_ops.build_filterbank(100, N_BAND)["hk"]
        loss_fn = tt.make_finetune_loss(N_BAND, hk.shape[-1])
        xb = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4, 1, 8192)).astype(np.float32)).to(dev)
        hkt = torch.from_numpy(hk).to(dev)
        lc, gc = tt.loss_and_grad(loss_fn, hkt, xb)
        ll, gl = tt.loss_and_grad(loss_fn, hkt, xb[2 * rank:2 * rank + 2])
        dist.all_reduce(ll)
        dist.all_reduce(gl)
        rel = abs(ll.item() / 2 - lc.item()) / lc.item()
        gerr = ((gl / 2 - gc).abs().max() / gc.abs().max()).item()
        assert rel <= TRAIN_LOSS_RTOL and gerr <= TRAIN_GRAD_RTOL, (rel,
                                                                    gerr)
        init_m, step_m = tt.make_train_step(tt.adam(2e-5), mesh=mesh,
                                            loss_fn=loss_fn, **on)
        init_u, step_u = tt.make_train_step(tt.adam(2e-5), loss_fn=loss_fn,
                                            **on)
        sm, su = init_m(hk), init_u(hk)
        graph_refused(lambda: step_m(sm, xb), "train step")
        sm = init_m(hk)
        _mesh_reset()
        _, lm = step_m.eager(sm, xb)
        res["launches"]["train step.eager"] = _mesh_counts()
        _, lu = step_u.eager(su, xb)
        step_rel = abs(lm.item() - lu.item()) / lu.item()
        hk_err = (sm.hk - su.hk).abs().max().item()
        assert step_rel <= TRAIN_LOSS_RTOL and hk_err <= 2 * 2e-5, (
            step_rel, hk_err)
        res["checks"]["DP loss rel, grad rel (mean of 2 ranks)"] = [rel,
                                                                    gerr]
        res["checks"]["DP step loss rel, max|dhk|"] = [step_rel, hk_err]
    return res


def _mesh_runs(card: str, dev: str = "cuda") -> dict:
    """Spawn the three runs together on the card and return every rank's
    results; a rank that fails or hangs fails the smoke."""
    import torch.multiprocessing as mp

    td = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ctx = mp.get_context("spawn")
    procs = []
    t0 = time.perf_counter()
    for which, (backend, world) in MESH_RUNS.items():
        init = "file://" + os.path.join(td, f"{which}.rendezvous")
        for r in range(world):
            p = ctx.Process(target=_mesh_rank,
                            args=(r, world, init, backend, which, td, dev))
            p.start()
            procs.append(p)
    deadline = time.monotonic() + MESH_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = [open(os.path.join(td, f)).read() for f in sorted(os.listdir(td))
            if f.endswith(".err")]
    codes = [p.exitcode for p in procs]
    assert not hung and not any(codes) and not errs, (
        f"mesh ranks: {len(hung)} hung, exit codes {codes}\n"
        + "\n".join(errs))
    out = {}
    for which, (_, world) in MESH_RUNS.items():
        out[which] = []
        for r in range(world):
            with open(os.path.join(td, f"{which}_{r}.json")) as f:
                out[which].append(json.load(f))
    shutil.rmtree(td)
    out["seconds"] = time.perf_counter() - t0
    return out


def _shard_bound(kind: str, B: int, T: int, M: int, Mb: int, K: int,
                 precision: str = "highest") -> tuple:
    """``_bound`` for a band shard of Mb of M bands: K1 [B, 1, T] ->
    [B, Mb, T_out] (K taps, stride M); K2 [B, Mb, T] -> [B, T_out, M]; K4
    [B, 1, T] -> [B, Mb, T/M] (K = L taps a phase); K5 [B, Mb, T] ->
    [B, 1, M*T] (K = L)."""
    if kind == "analysis":
        t_out = (T - K) // M + 1
        fma, io = B * t_out * Mb * K, B * T + Mb * K + B * Mb * t_out
    elif kind == "synthesis":
        t_out = T - K + 1
        fma, io = (B * t_out * M * Mb * K,
                   B * Mb * T + M * Mb * K + B * t_out * M)
    elif kind == "polyphase_analysis":
        fma, io = B * T * Mb * K, B * T + B * Mb * T // M + Mb * M * K
    else:  # polyphase_synthesis
        fma, io = B * T * M * Mb * K, B * Mb * T + B * M * T + M * Mb * K
    peak = F32_FLOPS if precision == "highest" else BF16_FLOPS
    ops_ms = 2 * fma * PASSES[precision] / peak * 1e3
    bytes_ms = 4 * io / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def _shard_kernels(card: str, dev: str = "cuda") -> dict:
    """(c) K1/K2 (K1t/K2t) and K4/K5 at the band shards Mb = 8 and 4 of the
    16-band bank, every rank's shard (first band 0, 4, 8 or 12: even), at
    every tier, against their plain versions on the card (K12_TOL), the
    output memory NaN-filled before each call; then each at its headline
    shape (a 8192-sample block for K1/K2, 60 s for K4/K5, a shard's part)
    timed against its plain version and one ``F.conv1d`` of the same
    product (``library_ms``; TF32 at the tiers, as phase 4's), with their
    device times and its bound."""
    import torch
    import torch.nn.functional as F

    from pqmf_tpu_torch import PQMF, StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk

    sp, pq = (StreamingPQMF(100, N_BAND, device=dev),
              PQMF(100, N_BAND, device=dev))
    wa, ws = sp.hkf, sp.hki
    hp, hi = pq.params["hk_poly"], pq.params["hk_ipoly"]
    Ka, Ks, L = wa.shape[-1], ws.shape[-1], hp.shape[-1]
    gen = torch.Generator(device="cpu").manual_seed(15)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def nan_junk():
        junk = torch.full((1 << 22,), float("nan"), device=dev)
        del junk

    errs, rows = {}, {}
    x_blk = {B: rand(B, 1, BLOCK + Ka - 1) for B in (1, 16)}
    x60 = rand(1, 1, 60 * SR // N_BAND * N_BAND)
    print(f"  band-shard kernels vs plain on {card}:")
    for Mb in (8, 4):
        for tier in ("highest", "bf16x3", "default"):
            for r in range(N_BAND // Mb):
                sl = slice(r * Mb, (r + 1) * Mb)
                w_a, w_s = wa[sl].contiguous(), ws[:, sl].contiguous()
                hp_s, hi_s = hp[sl].contiguous(), hi[:, sl].contiguous()
                w2 = pk.analysis_weights(hp_s)
                banks = ({} if tier == "highest" else {
                    k: cc.arrange_tc_bank(w, kind, tier) for k, w, kind in (
                        ("a", w_a, "analysis"), ("s", w_s, "synthesis"),
                        ("4", w2, "analysis"), ("5", hi_s, "synthesis"))})
                cases = []
                for B, x in x_blk.items():
                    sub = rand(B, Mb, BLOCK // N_BAND + Ks - 1)
                    cases += [
                        ("K1", lambda x=x: cc.strided_analysis_conv(
                            x, w_a, N_BAND, mxu_precision=tier,
                            bank=banks.get("a")),
                         lambda x=x: cc.analysis_conv_plain(
                             x, w_a, N_BAND, precision=tier), B),
                        ("K2", lambda s=sub: cc.dense_synthesis_conv(
                            s, w_s, True, -16, tier, bank=banks.get("s")),
                         lambda s=sub: cc.synthesis_conv_plain(
                             s, w_s, True, -16, tier), B)]
                if tier == "highest":
                    xb = x_blk[1][..., :BLOCK].contiguous()
                    sub5 = rand(1, Mb, 60 * SR // N_BAND)
                    cases += [
                        ("K4", lambda xx=xb: pk.polyphase_analysis(
                            xx, hp_s, w2),
                         lambda xx=xb: pk.polyphase_analysis_plain(xx, hp_s),
                         1),
                        ("K4", lambda: pk.polyphase_analysis(x60, hp_s, w2),
                         lambda: pk.polyphase_analysis_plain(x60, hp_s), 1),
                        ("K5", lambda: pk.polyphase_synthesis(sub5, hi_s),
                         lambda: pk.polyphase_synthesis_plain(sub5, hi_s),
                         1)]
                for name, kern, plain, B in cases:
                    nan_junk()
                    got = kern()
                    want = plain()
                    assert got.shape == want.shape and \
                        torch.isfinite(got).all(), (name, Mb, tier)
                    torch.testing.assert_close(
                        got, want, **K12_TOL,
                        msg=lambda m: f"{name} Mb={Mb} [{tier}]: {m}")
                    key = (name, Mb, tier)
                    errs[key] = max(errs.get(key, 0.0),
                                    (got - want).abs().max().item())
            print(f"    Mb={Mb} [{tier}]: " + ", ".join(
                f"{k[0]} max|err| {v:.3g}" for k, v in errs.items()
                if k[1:] == (Mb, tier)))
    # the headline shapes: rank 0's shard
    for Mb in (8, 4):
        sl = slice(0, Mb)
        w_a, w_s = wa[sl].contiguous(), ws[:, sl].contiguous()
        hp_s, hi_s = hp[sl].contiguous(), hi[:, sl].contiguous()
        w2 = pk.analysis_weights(hp_s)
        xk1 = x_blk[1]
        xk2 = rand(1, Mb, BLOCK // N_BAND + Ks - 1)
        x5 = rand(1, Mb, 60 * SR // N_BAND)
        for tier in ("highest", "bf16x3", "default"):
            ba = None if tier == "highest" else cc.arrange_tc_bank(
                w_a, "analysis", tier)
            bs = None if tier == "highest" else cc.arrange_tc_bank(
                w_s, "synthesis", tier)
            specs = [
                ("K1", "analysis", xk1,
                 lambda: cc.strided_analysis_conv(xk1, w_a, N_BAND,
                                                  mxu_precision=tier, bank=ba),
                 lambda: cc.analysis_conv_plain(xk1, w_a, N_BAND,
                                                precision=tier),
                 lambda: F.conv1d(xk1, w_a, stride=N_BAND), Ka),
                ("K2", "synthesis", xk2,
                 lambda: cc.dense_synthesis_conv(xk2, w_s, True, -16, tier,
                                                 bank=bs),
                 lambda: cc.synthesis_conv_plain(xk2, w_s, True, -16, tier),
                 lambda: F.conv1d(xk2, w_s), Ks)]
            if tier == "highest":
                x4p = F.pad(x60, (256, 240))
                x5p = F.pad(x5, (15, 16))
                specs += [
                    ("K4", "polyphase_analysis", x60,
                     lambda: pk.polyphase_analysis(x60, hp_s, w2),
                     lambda: pk.polyphase_analysis_plain(x60, hp_s),
                     lambda: F.conv1d(x4p, w2, stride=N_BAND), L),
                    ("K5", "polyphase_synthesis", x5,
                     lambda: pk.polyphase_synthesis(x5, hi_s),
                     lambda: pk.polyphase_synthesis_plain(x5, hi_s),
                     lambda: F.conv1d(x5p, hi_s), L)]
            for name, kind, x, kern, plain, lib, K in specs:
                if tier != "highest":  # the tiers' yardstick: TF32 cuDNN
                    def lib(lib=lib):
                        with _tf32():
                            return lib()
                iters = 20 if name in ("K4", "K5") else 200
                p1, k1 = _events_ms(plain, iters), _events_ms(kern, iters)
                k2, p2 = _events_ms(kern, iters), _events_ms(plain, iters)
                lib_ms = min(_events_ms(lib, iters) for _ in range(2))
                n_dev = 10 if name in ("K4", "K5") else 50
                dev_us = _device_us(kern, n_dev)
                lib_dev_us = _device_us(lib, n_dev)
                B_, _, T_ = x.shape
                bound = _shard_bound(kind, B_, T_, N_BAND, Mb, K, tier)
                rows[name, Mb, tier] = {
                    "ms": min(k1, k2), "plain_ms": min(p1, p2),
                    "library_ms": lib_ms, "device_us": dev_us,
                    "library_device_us": lib_dev_us,
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "shape": list(x.shape),
                    "max_abs_err": errs[name, Mb, tier]}
                print(f"    {name} Mb={Mb} [{tier}] x{tuple(x.shape)}: "
                      f"kernel {min(k1, k2):.4f} ms (device {dev_us:.2f} "
                      f"us), plain {min(p1, p2):.4f}, F.conv1d {lib_ms:.4f} "
                      f"ms (device {lib_dev_us:.2f} us), bound "
                      f"{bound[0]:.5f} ms ({bound[1]})")
    return rows


def _mesh_phase(card: str, dev: str = "cuda") -> tuple:
    """Phase 6: the (data, band) mesh on the card (the mesh runs, then the
    band-shard kernels). Returns (summary, the kernels line's shard
    rows). ``dev="cpu"`` rehearses the mesh runs on the plain versions."""
    print(f"the (data, band) mesh on {card} (one card: correctness, not "
          f"scaling):")
    runs = _mesh_runs(card, dev)
    for which, (backend, world) in MESH_RUNS.items():
        for r, res in enumerate(runs[which]):
            for what, v in res["checks"].items():
                print(f"  {which} rank {r}: {what}: {v}")
            for what, n in res["launches"].items():
                print(f"  {which} rank {r} launches, {what}: {n}")
    a = runs["nccl_1x1"][0]
    if dev == "cuda":
        g, t = a["sharded_step_graph"], a["times_ms"]
        print(f"  nccl_1x1: one replay of the sharded step = "
              f"{g['launches_a_replay']} launches, "
              f"{g['collectives_a_replay']} collectives; the sharded step's "
              f"graph {t['sharded_step_graph']:.4f} ms vs the unsharded "
              f"{t['unsharded_step_graph']:.4f} ms (CUDA events, {card}; "
              f"one-card correctness run, not scaling)")
        assert g["collectives_a_replay"]["band_all_reduce"] == 1, g
    for which in ("gloo_1x2", "gloo_1x4") if dev == "cuda" else ():
        for res in runs[which]:
            la = res["launches"]
            n = la["ShardedPitchShift.eager x8"]
            assert (n["K1"], n["K2"], n["band_all_reduce"]) == (8, 8, 8), n
            for tier in ("highest", "bf16x3", "default"):
                n = la[f"StreamingPQMF forward + roundtrip [{tier}]"]
                assert (n["K1"], n["K2"], n["K3"]) == (2, 1, 0), n
    print(f"  mesh runs: {runs['seconds']:.1f} s")
    rows = _shard_kernels(card) if dev == "cuda" else {}
    return runs, rows


# -- 7. the entry points (pqmf_tpu_torch/entry.py) ---------------------------

ENTRY_STEPS = 3


def _entry_phase(card: str, block_ms: float, flagship) -> dict:
    """Phase 7: ``entry()``'s step on the card for ``ENTRY_STEPS`` carried
    steps against ``entry(device="cpu")``'s, on seeded blocks (>= 90 dB) and
    on its own example input (held at ``entry.EXAMPLE_FLOOR_DB``: an
    ill-conditioned input, see there), one K1 and one K2 a step; its CUDA
    event ms beside the flagship block's graph (``flagship``, phase 4's
    wrapper, on the same card-resident block, and phase 4's ``block_ms``,
    which copies a NumPy block each call); ``dryrun_multichip(4)`` on
    the card; K4 and K4t without the sign mask (``fuse_mask=False``)
    against their plain versions at K12_TOL, at the host blocks and on
    60 s. Returns the phase's numbers and K4's errors by tier."""
    import torch

    from pqmf_tpu_torch import PQMF
    from pqmf_tpu_torch import entry as ent
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk
    from pqmf_tpu_torch.utils.metrics import snr_db

    out = {"steps": {}}
    fg, (tail_g, x_g) = ent.entry()
    fc, (tail_c, x_c) = ent.entry(device="cpu")
    assert x_g.is_cuda and tail_g.is_cuda and torch.equal(x_g.cpu(), x_c)
    blocks = np.split(_audio(ENTRY_STEPS * BLOCK, 23), ENTRY_STEPS, axis=-1)
    for label, xs, bar in (
            ("seeded blocks", [torch.from_numpy(b)[None] for b in blocks],
             BAR_DB),
            ("example x", [x_c] * ENTRY_STEPS, ent.EXAMPLE_FLOOR_DB)):
        tg, tc = tail_g, tail_c
        torch.cuda.synchronize()
        cc.reset_launches()
        ys = []
        for x in xs:
            tg, y = fg(tg, x.cuda())
            ys.append(y)
        torch.cuda.synchronize()
        n = dict(cc.LAUNCHES)
        assert (n["analysis"], n["synthesis"], n["roundtrip"]) == (
            ENTRY_STEPS, ENTRY_STEPS, 0), (label, n)
        dbs = []
        for i, x in enumerate(xs):
            tc, yc = fc(tc, x)
            assert ys[i].shape == yc.shape == (1, BLOCK)
            assert torch.isfinite(ys[i]).all()
            dbs.append(snr_db(yc.numpy(), ys[i].cpu().numpy()))
        tail_db = snr_db(tc.numpy(), tg.cpu().numpy())
        print(f"  entry() step, {label}: {ENTRY_STEPS} carried steps "
              f"{', '.join(f'{d:.2f}' for d in dbs)} dB vs entry('cpu'), "
              f"tail {tail_db:.2f} dB (bar {bar} dB); launches {n}")
        assert min(dbs) >= bar and tail_db >= bar, (label, dbs, tail_db)
        out["steps"][label] = {"y_db": dbs, "tail_db": tail_db,
                               "launches": n, "bar_db": bar}
    state = {"t": tail_g}

    def step():
        state["t"], _ = fg(state["t"], x_g)

    fstate = {"s": flagship.init_state()}

    def flagship_step():
        fstate["s"], _ = flagship.pitchshift_fn(fstate["s"], x_g)

    out["entry_step_graph_ms"] = _events_ms(step, 100)
    out["flagship_block_graph_ms_same_block"] = _events_ms(flagship_step,
                                                           100)
    out["flagship_block_graph_ms_numpy_block"] = block_ms
    print(f"  {card}: entry() step {out['entry_step_graph_ms']:.4f} ms "
          f"beside the flagship block's graph "
          f"{out['flagship_block_graph_ms_same_block']:.4f} ms on the same "
          f"card-resident block ({block_ms:.4f} ms with phase 4's NumPy "
          f"block copied in; CUDA events, the same program, entry's "
          f"default shifts against phase 4's SHIFTS16)")

    t0 = time.perf_counter()
    res = ent.dryrun_multichip(4)
    out["dryrun"] = {"seconds": time.perf_counter() - t0,
                     "checks": res["checks"], "launches": res["launches"],
                     "mesh": res["mesh"]}
    n = res["launches"]["sharded step"]
    assert n["K1"] >= 1 and n["K2"] >= 1, n
    print(f"  dryrun_multichip(4) on {card}: {out['dryrun']['seconds']:.1f} "
          f"s, rank 0 {res['checks']}, launches {res['launches']}")

    # K4 and K4 over K1t without the sign mask (phase 2's shapes)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(16)
    raw60 = torch.from_numpy(_headline_signal(60 * SR)).to(dev)[None, None]
    errs = {}
    for M in (4, 16, 32, 64):
        pq = PQMF(100, M, device="cuda")
        hp, w2 = pq.params["hk_poly"], pq._w2
        xs = [torch.randn(B, 1, BLOCK, generator=gen).to(dev)
              for B in (1, 16)]
        if M == 16:
            xs.append(raw60)
        for tier in ("highest",) + TIERS:
            bank = (None if tier == "highest"
                    else cc.arrange_tc_bank(w2, "analysis", tier))
            for x in xs:
                junk = torch.full((1 << 22,), float("nan"), device=dev)
                del junk
                pk.reset_launches()
                got = pk.polyphase_analysis(x, hp, w2, fuse_mask=False,
                                            mxu_precision=tier,
                                            tc_bank=bank)
                torch.cuda.synchronize()
                assert pk.LAUNCHES["analysis"] == 1
                ref = pk.polyphase_analysis_plain(x, hp, tier,
                                                  fuse_mask=False)
                assert got.shape == ref.shape and torch.isfinite(got).all()
                torch.testing.assert_close(got, ref, **K12_TOL)
                err = (got - ref).abs().max().item()
                errs[tier] = max(errs.get(tier, 0.0), err)
                print(f"  K4 fuse_mask=False M={M} x{tuple(x.shape)} "
                      f"[{tier}]: max|err| {err:.3g}")
    out["k4_no_mask_max_abs_err"] = errs
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the "
              "card", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from pqmf_tpu_torch import (PQMF, PhaseVocoderPitchShift,
                                PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, PQMFWrapper,
                                ResamplePitchShift, StreamingPQMF,
                                TorchaudioPitchShift, load_artifact,
                                save_artifact, stream_ola)
    from pqmf_tpu_torch import native
    from pqmf_tpu_torch.cli import blocks as blocks_cli
    from pqmf_tpu_torch.cli import (export_pqmf, export_pvoc, ps_torchaudio,
                                    vocoder)
    from pqmf_tpu_torch.kernels import _build
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk
    from pqmf_tpu_torch.ops import filterbank as fb_ops
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank
    from pqmf_tpu_torch.streaming import centered_padding
    from pqmf_tpu_torch.utils.audio import read_wav, write_wav
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
    cap = torch.backends.cpu.get_cpu_capability()
    print(f"CPU reference pinned: {CPU_PIN}, ATen capability {cap}")
    assert cap == "AVX2", cap
    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    # the native C data layer, before any wav is read or written
    t0 = time.perf_counter()
    wavio = native.build()
    native_build_s = time.perf_counter() - t0
    assert wavio is not None and native.get() is not None, \
        "the native C library did not build"
    print(f"native build: {native_build_s:.2f} s -> {wavio.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
        if "spill" in line:
            assert " 0 bytes spill stores, 0 bytes spill loads" in line, line
    bank = StreamingPQMF(100, N_BAND, device="cpu")
    hkf, hki = bank.hkf, bank.hki
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    for i, which in enumerate(("analysis", "synthesis", "roundtrip"), 1):
        c_bytes = lib.pqmf_smem_bytes(i, N_BAND, N_BAND, Ka, Ks)
        assert c_bytes == cc.smem_bytes(which, N_BAND, N_BAND, Ka, Ks), which
        print(f"smem {which}: {c_bytes} B")
    # K3 and K3t at M = 32 and 64: their gates, at the committed banks' and
    # the offline path's geometries
    # and the whole-file clusters the card holds at once (a cluster lives
    # in one GPC: cudaOccupancyMaxActiveClusters, never n_sms / C)
    clusters = {}
    for M_, Ka_, Ks_ in [(32, 1025, 33), (32, 1024, 32), (64, 2049, 33),
                         (64, 2048, 32)]:
        c_bytes = lib.pqmf_smem_bytes(3, M_, M_, Ka_, Ks_)
        assert c_bytes == cc.smem_bytes("roundtrip", M_, M_, Ka_, Ks_)
        t_bytes = {t: lib.pqmf_tc_smem_bytes(3, M_, M_, Ka_, Ks_, PASSES[t])
                   for t in TIERS}
        for t in TIERS:
            assert t_bytes[t] == cc.smem_bytes("roundtrip", M_, M_, Ka_, Ks_,
                                               t), (M_, Ka_, t)
        assert all(cc.fused_roundtrip_supported(M_, Ka_, Ks_, t)
                   for t in ("highest",) + TIERS), (M_, Ka_, Ks_)
        size = {}
        for t in ("highest",) + TIERS:
            clusters[M_, Ka_, Ks_, t] = cc.max_clusters(M_, Ka_, Ks_, t)
            size[t] = cc.launch_plan("roundtrip", 1, M_, M_, Ka_, Ks_,
                                     1 << 20, precision=t)[6]
        print(f"smem roundtrip M={M_} Ka={Ka_} Ks={Ks_}: {c_bytes} B, "
              f"K3t {t_bytes['bf16x3']} / {t_bytes['default']} B; "
              "whole-file clusters the card holds: " + ", ".join(
                  f"{t} {clusters[M_, Ka_, Ks_, t]} of {size[t]} blocks"
                  for t in ("highest",) + TIERS))
    # the launch plans the CUDA source makes, against their Python mirror,
    # at the main paths' shapes (K4-K6 are K1-K3 at the offline geometry)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = (ctypes.c_longlong * 8)()
    for which, args in [
            ("analysis", (1, 16, 16, Ka, 0, BLOCK // 16)),
            ("analysis", (16, 16, 16, Ka, 0, BLOCK // 16)),
            ("analysis", (1, 16, 16, 512, 0, 60 * SR // 16)),
            ("analysis", (1, 8, 8, 257, 0, 256)),
            ("analysis", (215, 16, 16, Ka, 0, OLA_BLOCK // 16)),
            ("analysis", (1, 32, 32, 1024, 0, 4096)),
            ("analysis", (1, 64, 64, 2048, 0, 2048)),
            ("analysis", (1, 16, 6, Ka, 0, BLOCK // 16)),
            ("synthesis", (1, 16, 16, 0, Ks, BLOCK // 16)),
            ("synthesis", (16, 16, 16, 0, Ks, BLOCK // 16)),
            ("synthesis", (1, 16, 16, 0, 32, 60 * SR // 16)),
            ("synthesis", (1, 8, 8, 0, Ks, 256)),
            ("synthesis", (1, 32, 32, 0, 32, 4096)),
            ("synthesis", (1, 64, 64, 0, 32, 2048)),
            ("roundtrip", (1, 16, 16, Ka, Ks, 60 * SR // 16 + 1)),
            ("roundtrip", (1, 16, 16, 512, 32, 60 * SR // 16 + 1)),
            ("roundtrip", (1, 16, 16, Ka, Ks, BLOCK // 16)),
            ("roundtrip", (16, 16, 16, Ka, Ks, BLOCK // 16)),
            ("roundtrip", (215, 16, 16, Ka, Ks, OLA_BLOCK // 16)),
            ("roundtrip", (1, 8, 8, 257, 33, 300)),
            ("roundtrip", (1, 32, 32, 1025, 33, 60 * SR // 32 + 1)),
            ("roundtrip", (1, 32, 32, 1025, 33, BLOCK // 32)),
            ("roundtrip", (16, 32, 32, 1025, 33, BLOCK // 32)),
            ("roundtrip", (1, 32, 32, 1024, 32, 60 * SR // 32)),
            ("roundtrip", (1, 64, 64, 2049, 33, 60 * SR // 64 + 1)),
            ("roundtrip", (1, 64, 64, 2049, 33, BLOCK // 64)),
            ("roundtrip", (16, 64, 64, 2049, 33, BLOCK // 64)),
            ("roundtrip", (1, 64, 64, 2048, 32, 60 * SR // 64))]:
        code = {"analysis": 1, "synthesis": 2, "roundtrip": 3}[which]
        big_rt = which == "roundtrip" and args[1] >= 32
        for tier in ("highest",) + TIERS:
            mc = clusters[args[1], args[3], args[4], tier] if big_rt else 0
            if tier == "highest":
                assert lib.pqmf_launch_plan(code, *args, n_sms, mc,
                                            plan) == 0
            else:  # the tier kernels' plans (csrc/cached_conv_tc.cu)
                assert lib.pqmf_tc_launch_plan(code, *args, n_sms,
                                               PASSES[tier], mc, plan) == 0
                gate = lib.pqmf_tc_smem_bytes(code, *args[1:5], PASSES[tier])
                assert gate == cc.smem_bytes(which, *args[1:5], tier)
            mirror = cc.launch_plan(which, *args, n_sms=n_sms, precision=tier,
                                    max_clusters=mc if big_rt else None)
            assert tuple(plan) == mirror, (which, args, tier, tuple(plan),
                                           mirror)
            assert mirror[7] <= cc.smem_bytes(which, *args[1:5], tier) \
                <= cc.SMEM_LIMIT, (mirror, tier)
            if tier == "default" and not big_rt:
                continue  # K1t/K2t/K3t up to M = 16: the plan of bf16x3
            cl = (f", clusters of {mirror[6]} x {mirror[0] // mirror[6]}"
                  if big_rt else "")
            print(f"plan {which} {args} [{tier}]: grid {mirror[:3]}, "
                  f"{mirror[3]} threads, {mirror[4]} steps a tile, "
                  f"{mirror[7]} B{cl}")
    wa, ws = hkf.to(dev), hki.to(dev)

    # -- 2. kernels vs plain, on the card -------------------------------------
    errs = {"analysis": 0.0, "synthesis": 0.0, "roundtrip": 0.0,
            "polyphase_analysis": 0.0, "polyphase_synthesis": 0.0,
            "polyphase_roundtrip": 0.0, "roundtrip_m32": 0.0,
            "roundtrip_m64": 0.0, "polyphase_roundtrip_m32": 0.0,
            "polyphase_roundtrip_m64": 0.0}

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
    # K1 at its tile boundaries (T_out one short of, at and one past a
    # multiple of the tile) in a small call (split phase sum) and a large
    # one (persistent blocks), with its in-kernel pad
    for B in (1, 3, 16):
        for t_probe in (BLOCK // 16, 40000):
            tile = cc.launch_plan("analysis", B, 16, 16, Ka, 0, t_probe,
                                  n_sms=n_sms)[4]
            for edge, pad in [(-1, (256, 256)), (0, (7, 3)), (1, (0, 0))]:
                T_out = (t_probe // tile) * tile + edge
                x = rand(B, 1, (T_out - 1) * 16 + Ka - sum(pad) + 5)
                check("analysis",
                      cc.strided_analysis_conv(x, wa, 16, True, pad),
                      cc.analysis_conv_plain(x, wa, 16, True, pad), K12_TOL,
                      f"K1 tile {tile} T_out {T_out} B={B} pad={pad}")
    for B, T in [(1, BLOCK // 16), (16, BLOCK // 16), (3, 37)]:
        for fuse, off in [(True, -16), (True, -15), (True, 3), (True, 0),
                          (False, 0)]:
            x = rand(B, 16, T + Ks - 1)
            check("synthesis",
                  cc.dense_synthesis_conv(x, ws, fuse, off),
                  cc.synthesis_conv_plain(x, ws, fuse, off), K12_TOL,
                  f"K2 x{tuple(x.shape)} fuse_mask={fuse} x_offset={off}")
        # the pad in K2's window copy: the flagship's (16, 16) (16-byte
        # copies) and K5's (15, 16) (single floats)
        for pad in [(16, 16), (15, 16)]:
            x = rand(B, 16, T)
            check("synthesis",
                  cc.dense_synthesis_conv(x, ws, True, 0, pad=pad),
                  cc.synthesis_conv_plain(x, ws, True, 0, pad=pad), K12_TOL,
                  f"K2 x{tuple(x.shape)} pad={pad}")
    sixty = _headline_signal(60 * SR)
    x60 = F.pad(torch.from_numpy(sixty).to(dev)[None, None], (256, 256))
    for x, pad in [(rand(1, 1, BLOCK + pad_a), (16, 16)), (x60, (16, 16)),
                   (rand(2, 1, 16 * 300 + pad_a + 7), (3, 0)),
                   (rand(1, 1, 16 * 129 + pad_a), (0, 40))]:
        check("roundtrip", cc.fused_roundtrip_conv(x, wa, ws, 16, pad),
              cc.roundtrip_conv_plain(x, wa, ws, 16, pad), K3_TOL,
              f"K3 x{tuple(x.shape)} syn_pad={pad}")

    # K3 at M = 32 and 64 (roundtrip_cluster_kernel: a cluster of M/8
    # blocks a tile): a host block at B = 1, 3, 16, lopsided synthesis pads, and
    # the 60 s signal with the centered pads in the kernel; the sums run in
    # one thread in K1's and K2's order, so K1/K2's bar
    big = {}
    for M in (32, 64):
        sp_m = StreamingPQMF(100, M, device="cpu")
        big[M] = (sp_m.hkf.to(dev), sp_m.hki.to(dev))
    for M, (bw_a, bw_s) in big.items():
        ka, ks = bw_a.shape[-1], bw_s.shape[-1]
        for x, pad, apad in [
                (rand(1, 1, BLOCK + ka - 1), (ks // 2, ks // 2), (0, 0)),
                (rand(3, 1, BLOCK + ka - 1), (3, 0), (0, 0)),
                (rand(16, 1, BLOCK + ka - 1), (0, 40), (0, 0)),
                (torch.from_numpy(sixty).to(dev)[None, None],
                 (ks // 2, ks // 2), (ka // 2, ka // 2))]:
            check(f"roundtrip_m{M}",
                  cc.fused_roundtrip_conv(x, bw_a, bw_s, M, pad, pad=apad),
                  cc.roundtrip_conv_plain(x, bw_a, bw_s, M, pad, pad=apad),
                  K12_TOL, f"K3 M={M} x{tuple(x.shape)} syn_pad={pad} "
                  f"pad={apad}")

    # K3 with the analysis pad in its window copy: the bits of F.pad and
    # the call
    for x in (rand(1, 1, BLOCK), rand(3, 1, 16 * 301 + 5)):
        got = cc.fused_roundtrip_conv(x, wa, ws, 16, (16, 16), pad=(256, 256))
        assert torch.equal(got, cc.fused_roundtrip_conv(
            F.pad(x, (256, 256)), wa, ws, 16, (16, 16))), "K3 pad"
    print("  K3 pad=(256, 256) bit-equal to F.pad and the call")

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

    # K4/K5/K6 over K1/K2/K3 at the offline geometries: even kernel lengths
    # (L*M and L), x_offset -(L//2-1), syn_pad (L//2, L//2), and at M=32/64
    # K1's band and K2's phase chunks with a short last chunk
    print("polyphase kernels vs plain:")
    offline = {M: PQMF(100, M, device="cuda") for M in (4, 16, 32, 64)}
    for M, pq in offline.items():
        hp, hi, w2 = pq.params["hk_poly"], pq.params["hk_ipoly"], pq._w2
        L = hp.shape[-1]
        assert pk.roundtrip_supported(M, L * M, L), M  # K6 at every M
        for B in (1, 16):
            x, sub = rand(B, 1, BLOCK), rand(B, M, BLOCK // M)
            check("polyphase_analysis", pk.polyphase_analysis(x, hp, w2),
                  pk.polyphase_analysis_plain(x, hp), K12_TOL,
                  f"K4 M={M} x{tuple(x.shape)}")
            check("polyphase_synthesis", pk.polyphase_synthesis(sub, hi),
                  pk.polyphase_synthesis_plain(sub, hi), K12_TOL,
                  f"K5 M={M} x{tuple(sub.shape)}")
            check("polyphase_roundtrip" if M <= 16
                  else f"polyphase_roundtrip_m{M}",
                  pk.polyphase_roundtrip(x, hp, hi, w2),
                  pk.polyphase_roundtrip_plain(x, hp, hi), K6_TOL,
                  f"K6 M={M} x{tuple(x.shape)}")
    # K6 at M = 32 and 64 on the 60 s signal (the main path's shape)
    raw60 = torch.from_numpy(sixty).to(dev)[None, None]
    for M in (32, 64):
        pq = offline[M]
        hp, hi, w2 = pq.params["hk_poly"], pq.params["hk_ipoly"], pq._w2
        x6 = raw60[..., : raw60.shape[-1] // M * M]
        check(f"polyphase_roundtrip_m{M}",
              pk.polyphase_roundtrip(x6, hp, hi, w2),
              pk.polyphase_roundtrip_plain(x6, hp, hi), K6_TOL,
              f"K6 M={M} 60 s x{tuple(x6.shape)}")
    pq16 = offline[16]
    hp, hi, w2 = pq16.params["hk_poly"], pq16.params["hk_ipoly"], pq16._w2
    sub60 = pk.polyphase_analysis(raw60, hp, w2)
    check("polyphase_analysis", sub60, pk.polyphase_analysis_plain(raw60, hp),
          K12_TOL, f"K4 60 s x{tuple(raw60.shape)}")
    check("polyphase_synthesis", pk.polyphase_synthesis(sub60, hi),
          pk.polyphase_synthesis_plain(sub60, hi), K12_TOL,
          f"K5 60 s x{tuple(sub60.shape)}")
    check("polyphase_roundtrip", pk.polyphase_roundtrip(raw60, hp, hi, w2),
          pk.polyphase_roundtrip_plain(raw60, hp, hi), K6_TOL,
          f"K6 60 s x{tuple(raw60.shape)}")
    x, sub = rand(2, 1, BLOCK), rand(2, 16, BLOCK // 16)
    for what, got, ref in [
            ("K4", pk.polyphase_analysis(x, hp, w2),
             pk.polyphase_analysis_plain(x.cpu(), hp.cpu())),
            ("K5", pk.polyphase_synthesis(sub, hi),
             pk.polyphase_synthesis_plain(sub.cpu(), hi.cpu())),
            ("K6", pk.polyphase_roundtrip(x, hp, hi, w2),
             pk.polyphase_roundtrip_plain(x.cpu(), hp.cpu(), hi.cpu()))]:
        got = got.cpu()
        torch.testing.assert_close(got, ref, **K6_TOL)
        print(f"  {what} vs the CPU's plain version: max|err| "
              f"{(got - ref).abs().max().item():.3g}")

    # -- 2b. the tier kernels vs plain at the same tier ------------------------
    # K1t/K2t/K3t (and K4-K6 over them) at bf16x3 and default: the main
    # paths' shapes, K1t/K2t at their 64-step tiles +-1 with odd and even K
    # and in-kernel pads, K3t at its tile, M = 2..64, a band shard, and
    # output memory NaN-filled before each call
    terrs = {(k, t): 0.0 for k in errs for t in TIERS}

    def tcheck(name, tier, got, ref, what, sub=None, w_syn=None):
        torch.cuda.synchronize()
        assert got.shape == ref.shape, (what, got.shape, ref.shape)
        assert torch.isfinite(got).all(), what
        err = (got - ref).abs().max().item()
        off = ""
        if w_syn is not None and tier == "default":
            off = (f", {_k3t_default_close(got, ref, sub, w_syn, what):.4%}"
                   f" past K3_TOL (M = {w_syn.shape[0]})")
        else:
            tol = K3T_BF16X3_TOL if w_syn is not None else K12_TOL
            torch.testing.assert_close(got, ref, **tol,
                                       msg=lambda m: f"{what}: {m}")
        terrs[name, tier] = max(terrs[name, tier], err)
        print(f"  {what} [{tier}]: max|err| {err:.3g}{off}")

    def nan_junk():
        junk = torch.full((1 << 22,), float("nan"), device=dev)
        del junk

    print("tier kernels vs plain:")
    tier_banks = {M: tuple(t.to(dev) for t in (
        StreamingPQMF(100, M, device="cpu").hkf,
        StreamingPQMF(100, M, device="cpu").hki)) for M in (2, 4, 8, 32, 64)}
    tier_banks[16] = (wa, ws)
    hp_cpu = PQMF(100, 16, device="cpu").params["hk_poly"]
    w2_16 = pk.analysis_weights(hp_cpu).to(dev)
    for tier in TIERS:
        for B, T in [(1, BLOCK), (16, BLOCK), (3, 16 * 37 + 5)]:
            x = rand(B, 1, T + pad_a)
            for fuse in (True, False):
                nan_junk()
                tcheck("analysis", tier,
                       cc.strided_analysis_conv(x, wa, 16, fuse,
                                                mxu_precision=tier),
                       cc.analysis_conv_plain(x, wa, 16, fuse,
                                              precision=tier),
                       f"K1t x{tuple(x.shape)} fuse_mask={fuse}")
        # K1t/K2t at T_out one short of, at and one past a multiple of the
        # tile their plan takes, for one host block (split reduction) and a
        # whole file (persistent blocks); a kept bank and one arranged for
        # the call give the same bits
        for B in (1, 16):
            for t_probe in (BLOCK // 16, -(-n_sms * 256 // B) + 64):
                for w, pad in [(wa, (256, 256)), (w2_16, (256, 240)),
                               (wa, (7, 3)), (wa[:6].contiguous(), (0, 0))]:
                    tile = cc.launch_plan("analysis", B, 16, w.shape[0],
                                          w.shape[-1], 0, t_probe,
                                          n_sms=n_sms, precision=tier)[4]
                    kept = cc.arrange_tc_bank(w, "analysis", tier)
                    for edge in (-1, 0, 1):
                        T_out = (t_probe // tile) * tile + edge
                        x = rand(B, 1,
                                 (T_out - 1) * 16 + w.shape[-1] - sum(pad))
                        nan_junk()
                        got = cc.strided_analysis_conv(x, w, 16, True, pad,
                                                       tier, kept)
                        tcheck("analysis", tier, got,
                               cc.analysis_conv_plain(x, w, 16, True, pad,
                                                      tier),
                               f"K1t Mb={w.shape[0]} K={w.shape[-1]} tile "
                               f"{tile} T_out {T_out} B={B} pad={pad}")
                        nan_junk()
                        assert torch.equal(got, cc.strided_analysis_conv(
                            x, w, 16, True, pad, tier)), "kept bank"
                tile = cc.launch_plan("synthesis", B, 16, 16, 0, Ks, t_probe,
                                      n_sms=n_sms, precision=tier)[4]
                kept = cc.arrange_tc_bank(ws, "synthesis", tier)
                for edge in (-1, 0, 1):
                    T_out = (t_probe // tile) * tile + edge
                    for pad, off in [((16, 16), 0), ((15, 16), 0),
                                     ((0, 0), -15), ((0, 0), 3)]:
                        x = rand(B, 16, T_out + Ks - 1 - sum(pad))
                        nan_junk()
                        got = cc.dense_synthesis_conv(x, ws, True, off, tier,
                                                      pad, kept)
                        tcheck("synthesis", tier, got,
                               cc.synthesis_conv_plain(x, ws, True, off, tier,
                                                       pad),
                               f"K2t tile {tile} T_out {T_out} B={B} "
                               f"pad={pad} x_offset={off}")
                        nan_junk()
                        assert torch.equal(got, cc.dense_synthesis_conv(
                            x, ws, True, off, tier, pad)), "kept bank"
        # K = 9001 / Ks = 600 (banks read from global memory), a band
        # shard of 6 input bands, and stride 1 / one input band
        g9 = torch.Generator(device="cpu").manual_seed(9001)
        for M_, Mb_, K_, Ks_ in [(16, 16, 9001, 600), (16, 6, 513, 33),
                                 (1, 2, 31, 33)]:
            w_a = (torch.randn(Mb_, 1, K_, generator=g9) / K_ ** 0.5).to(dev)
            w_s = (torch.randn(max(M_, 4), Mb_, Ks_, generator=g9)
                   / (max(M_, 4) * (Mb_ * Ks_) ** 0.5)).to(dev)
            x = rand(2, 1, 300 * M_ + K_)
            s_ = rand(2, Mb_, 300 + Ks_)
            nan_junk()
            tcheck("analysis", tier,
                   cc.strided_analysis_conv(x, w_a, M_, True, (M_, M_), tier),
                   cc.analysis_conv_plain(x, w_a, M_, True, (M_, M_), tier),
                   f"K1t M={M_} Mb={Mb_} K={K_}")
            nan_junk()
            tcheck("synthesis", tier,
                   cc.dense_synthesis_conv(s_, w_s, True, -3, tier),
                   cc.synthesis_conv_plain(s_, w_s, True, -3, tier),
                   f"K2t Mb={Mb_} Ks={Ks_}")
        for B in (1, 16):
            x = rand(B, 16, BLOCK // 16 + Ks - 1)
            nan_junk()
            tcheck("synthesis", tier,
                   cc.dense_synthesis_conv(x, ws, True, -16, tier),
                   cc.synthesis_conv_plain(x, ws, True, -16, tier),
                   f"K2t x{tuple(x.shape)} x_offset=-16")
        for M, (bw_a, bw_s) in sorted(tier_banks.items()):
            ka, ks = bw_a.shape[-1], bw_s.shape[-1]
            # one host block's worth of steps, and a whole file's
            for steps in (300, n_sms * 256 + 64):
                x = rand(1 if steps > 300 else 2, 1, M * steps + ka - 1)
                sub = cc.strided_analysis_conv(x, bw_a, M)
                nan_junk()
                tcheck("analysis", tier,
                       cc.strided_analysis_conv(x, bw_a, M,
                                                mxu_precision=tier),
                       cc.analysis_conv_plain(x, bw_a, M, precision=tier),
                       f"K1t M={M} x{tuple(x.shape)}")
                nan_junk()
                tcheck("synthesis", tier,
                       cc.dense_synthesis_conv(sub, bw_s, True, 0, tier,
                                               (ks // 2, ks // 2)),
                       cc.synthesis_conv_plain(sub, bw_s, True, 0, tier,
                                               (ks // 2, ks // 2)),
                       f"K2t M={M} x{tuple(sub.shape)} pad {ks // 2}")
            x = rand(2, 1, M * 300 + ka - 1)
            sub = F.pad(cc.strided_analysis_conv(x, bw_a, M), (ks // 2,) * 2)
            if cc.fused_roundtrip_supported(M, ka, ks, tier):
                for pad in [(ks // 2, ks // 2), (3, 0), (0, 40)]:
                    nan_junk()
                    tcheck("roundtrip" if M <= 16 else f"roundtrip_m{M}",
                           tier,
                           cc.fused_roundtrip_conv(x, bw_a, bw_s, M, pad,
                                                   tier),
                           cc.roundtrip_conv_plain(x, bw_a, bw_s, M, pad,
                                                   tier),
                           f"K3t M={M} x{tuple(x.shape)} syn_pad={pad}",
                           sub, bw_s)
            if M >= 32:
                # the main path's shapes: a whole file past n_sms * 256
                # steps and the 60 s signal (persistent blocks), the
                # centered analysis pad in the kernel
                syn = (ks // 2, ks // 2)
                for x, apad in [
                        (rand(1, 1, M * (n_sms * 256 + 64) + ka - 1), (0, 0)),
                        (raw60, (ka // 2, ka // 2))]:
                    nan_junk()
                    tcheck(f"roundtrip_m{M}", tier,
                           cc.fused_roundtrip_conv(x, bw_a, bw_s, M, syn,
                                                   tier, pad=apad),
                           cc.roundtrip_conv_plain(x, bw_a, bw_s, M, syn,
                                                   tier, pad=apad),
                           f"K3t M={M} x{tuple(x.shape)} syn_pad={syn} "
                           f"pad={apad}",
                           cc.strided_analysis_conv(x, bw_a, M, pad=apad),
                           bw_s)
        k3t_tile = cc.launch_plan("roundtrip", 1, 16, 16, Ka, Ks, 1000,
                                  precision=tier)[4]
        # one step short of and one past a multiple of the tile, with
        # lopsided synthesis pads (T_ana = T_out - pads + Ks - 1)
        t_rt = (1000 // k3t_tile) * k3t_tile
        for x, pad in [(x60, (16, 16)), (rand(1, 1, BLOCK + pad_a), (16, 16)),
                       (rand(2, 1, 16 * (t_rt - 3) + Ka), (16, 17)),
                       (rand(3, 1, 16 * (t_rt + 29) + Ka), (3, 0))]:
            nan_junk()
            tcheck("roundtrip", tier,
                   cc.fused_roundtrip_conv(x, wa, ws, 16, pad, tier),
                   cc.roundtrip_conv_plain(x, wa, ws, 16, pad, tier),
                   f"K3t x{tuple(x.shape)} syn_pad={pad}",
                   cc.strided_analysis_conv(x, wa, 16), ws)
        # K3t at the tiles of its plans +-1 (a host block and 16 streams:
        # tiles of 16-64 steps; stream_ola's 215 x 4096 and 60 s: persistent
        # tiles), the centered analysis pad in the kernel, the kept banks
        # (the same bits as banks arranged for the call) and pad= (the same
        # bits as F.pad and the call)
        rt_kept = (cc.arrange_tc_bank(wa, "analysis", tier),
                   cc.arrange_tc_bank(ws, "synthesis", tier))
        for B, t_probe in [(1, BLOCK // 16), (16, BLOCK // 16),
                           (215, OLA_BLOCK // 16), (1, 60 * SR // 16)]:
            tile = cc.launch_plan("roundtrip", B, 16, 16, Ka, Ks, t_probe,
                                  n_sms=n_sms, precision=tier)[4]
            for edge in (-1, 0, 1):
                T_out = (t_probe // tile) * tile + edge
                x = rand(B, 1, 16 * T_out)
                nan_junk()
                got = cc.fused_roundtrip_conv(x, wa, ws, 16, (16, 16), tier,
                                              (256, 256), rt_kept)
                tcheck("roundtrip", tier, got,
                       cc.roundtrip_conv_plain(x, wa, ws, 16, (16, 16), tier,
                                               (256, 256)),
                       f"K3t tile {tile} T_out {T_out} B={B} pad (256, 256)",
                       cc.strided_analysis_conv(x, wa, 16, pad=(256, 256)),
                       ws)
                nan_junk()
                assert torch.equal(got, cc.fused_roundtrip_conv(
                    x, wa, ws, 16, (16, 16), tier, (256, 256))), "kept banks"
                nan_junk()
                assert torch.equal(got, cc.fused_roundtrip_conv(
                    F.pad(x, (256, 256)), wa, ws, 16, (16, 16), tier,
                    banks=rt_kept)), "K3t pad"
        for M, pq in offline.items():
            hp_m, hi_m, w2_m = pq.params["hk_poly"], pq.params["hk_ipoly"], \
                pq._w2
            L = hp_m.shape[-1]
            for B in (1, 16):
                x, sub = rand(B, 1, BLOCK), rand(B, M, BLOCK // M)
                tcheck("polyphase_analysis", tier,
                       pk.polyphase_analysis(x, hp_m, w2_m,
                                             mxu_precision=tier),
                       pk.polyphase_analysis_plain(x, hp_m, tier),
                       f"K4 M={M} x{tuple(x.shape)}")
                tcheck("polyphase_synthesis", tier,
                       pk.polyphase_synthesis(sub, hi_m, tier),
                       pk.polyphase_synthesis_plain(sub, hi_m, tier),
                       f"K5 M={M} x{tuple(sub.shape)}")
                if pk.roundtrip_supported(M, L * M, L, tier):
                    tcheck("polyphase_roundtrip" if M <= 16
                           else f"polyphase_roundtrip_m{M}", tier,
                           pk.polyphase_roundtrip(x, hp_m, hi_m, w2_m, tier),
                           pk.polyphase_roundtrip_plain(x, hp_m, hi_m, tier),
                           f"K6 M={M} x{tuple(x.shape)}",
                           pk.polyphase_analysis(x, hp_m, w2_m), hi_m)
            if M >= 32:  # the main path's shape: 60 s
                x6 = raw60[..., : raw60.shape[-1] // M * M]
                nan_junk()
                tcheck(f"polyphase_roundtrip_m{M}", tier,
                       pk.polyphase_roundtrip(x6, hp_m, hi_m, w2_m, tier),
                       pk.polyphase_roundtrip_plain(x6, hp_m, hi_m, tier),
                       f"K6 M={M} 60 s x{tuple(x6.shape)}",
                       pk.polyphase_analysis(x6, hp_m, w2_m), hi_m)
        sub60_t = pk.polyphase_analysis(raw60, hp, w2, mxu_precision=tier)
        tcheck("polyphase_analysis", tier, sub60_t,
               pk.polyphase_analysis_plain(raw60, hp, tier), "K4 60 s")
        tcheck("polyphase_synthesis", tier,
               pk.polyphase_synthesis(sub60, hi, tier),
               pk.polyphase_synthesis_plain(sub60, hi, tier), "K5 60 s")
        tcheck("polyphase_roundtrip", tier,
               pk.polyphase_roundtrip(raw60, hp, hi, w2, tier),
               pk.polyphase_roundtrip_plain(raw60, hp, hi, tier), "K6 60 s",
               sub60, hi)

    # -- 3. the paths on the card vs the port on the CPU ----------------------
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
        stages = {}
        with (_stage_checksums(stages) if i == 0
              else contextlib.nullcontext()):
            cs, y = cpu.pitchshift_fn(cs, blk)
        assert g_out[i].shape == (1, BLOCK) and torch.isfinite(g_out[i]).all()
        if i == 0:
            # which side moved, if a rerun reads block 0 lower: the float64
            # sum and sum of |y| of each side's output, as hex floats, and
            # of each stage of the CPU reference
            print(json.dumps({"checksum_block0": {
                "card": _checksum(g_out[0].cpu()), "cpu": _checksum(y),
                "cpu_stages": stages}}))
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
    assert abs(rt_db - SNR_STREAM_DB[0]) <= SNR_STREAM_DB[1], rt_db

    # the flagship at each tier: its own main path, counts zeroed just
    # before and read just after, every plain conv refused; >= 90 dB
    # against the CPU port at the same tier
    tier_gpu, tier_launches, tier_db = {}, {}, {}
    for tier in TIERS:
        tg = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR, SHIFTS16,
                                   precision=tier, device="cuda")
        tc = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR, SHIFTS16,
                                   precision=tier, device="cpu")
        tier_gpu[tier] = tg
        cc.reset_launches()
        with _plain_versions_refused():
            ts_, t_out = tg.init_state(), []
            for blk in blocks:
                ts_, y = tg.pitchshift_fn(ts_, blk)
                t_out.append(y)
            tss, t_streams = tg.pitchshift_streams(tg.init_streams(16),
                                                   streams)
            t_rt = tg.forward_fn(blocks[0])
        torch.cuda.synchronize()
        tier_launches[tier] = dict(cc.LAUNCHES)
        print(f"main-path launches at {tier}: {tier_launches[tier]}")
        assert tier_launches[tier] == {"analysis": 9, "synthesis": 9,
                                       "roundtrip": 1}, tier_launches[tier]
        cs, dbs = tc.init_state(), []
        for i, blk in enumerate(blocks):
            cs, y = tc.pitchshift_fn(cs, blk)
            assert torch.isfinite(t_out[i]).all()
            dbs.append(snr_db(y.numpy(), t_out[i].cpu().numpy()))
        css, c_streams = tc.pitchshift_streams(tc.init_streams(16), streams)
        dbs += [snr_db(cs["prev_tail"].numpy(),
                       ts_["prev_tail"].cpu().numpy()),
                snr_db(c_streams.numpy(), t_streams.cpu().numpy()),
                snr_db(css["prev_tail"].numpy(),
                       tss["prev_tail"].cpu().numpy()),
                snr_db(tc.forward_fn(blocks[0]).numpy(), t_rt.cpu().numpy())]
        tier_db[tier] = dbs
        print(f"  {tier}: 8 blocks, tail, 16 streams, their tails, "
              f"forward_fn vs CPU: {[round(d, 1) for d in dbs]} dB")
        bars = [BAR_DB] * len(dbs)
        if tier == "default":
            own = [snr_db(g_out[i].cpu().numpy(), t_out[i].cpu().numpy())
                   for i in range(len(blocks))]
            own += [snr_db(a.cpu().numpy(), b.cpu().numpy()) for a, b in [
                (gs["prev_tail"], ts_["prev_tail"]), (g_streams, t_streams),
                (gss["prev_tail"], tss["prev_tail"]), (g_rt, t_rt)]]
            bars = [min(BAR_DB, o + DEFAULT_MARGIN_DB) for o in own]
            print(f"  default tier's own error on the card (vs highest): "
                  f"{[round(o, 1) for o in own]} dB; bars "
                  f"{[round(b, 1) for b in bars]} dB")
        assert all(d >= b for d, b in zip(dbs, bars)), (tier, dbs, bars)
    y60_t = tier_gpu["bf16x3"].pqmf.roundtrip(
        torch.from_numpy(sixty).to(dev)[None, None])
    rt_db_t = aligned_roundtrip_snr_db(sixty, y60_t[0, 0].cpu().numpy(),
                                       pq.centered_delay)
    print(f"60 s round trip (K3t, bf16x3) whole-signal SNR: {rt_db_t:.4f} dB")
    assert abs(rt_db_t - SNR_STREAM_DB[0]) <= SNR_STREAM_DB[1], rt_db_t

    # diagnostic: the default flagship with its DFT operands left in f32 on
    # both sides (ops.stft.dft_matmul at its "highest" path, in this phase
    # only), so the only bf16 roundings left are K1t's and K2t's. K1t
    # rounds the signal, which both sides hold bit-equal; K2t rounds the
    # shifted sub-bands, which the middle computes on each device, so they
    # differ by f32 ulps and a few round to the other bf16 neighbour. The
    # phase reads the flagship against the CPU, the share of K2t's inputs
    # whose bf16 rounding differs between the devices, and K2t on the card
    # against the CPU's plain version on the CPU's own inputs (the conv
    # alone: >= BAR_DB). It records K2t's inputs from Python, so it drives
    # the eager bodies: a graph replay runs no Python.
    from pqmf_tpu_torch.ops import stft as S_ops

    dft_real, syn_real = S_ops.dft_matmul, cc.dense_synthesis_conv
    k2_calls = {"cuda": [], "cpu": []}

    def syn_rec(x, *args, **kwargs):
        y = syn_real(x, *args, **kwargs)
        k2_calls[x.device.type].append((x.detach().clone(), kwargs,
                                        y.detach().clone()))
        return y

    S_ops.dft_matmul = lambda a, b, precision="highest": dft_real(a, b)
    cc.dense_synthesis_conv = syn_rec
    try:
        tg, tc = (PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR, SHIFTS16,
                                        precision="default", device=d)
                  for d in ("cuda", "cpu"))
        gs_d, cs_d, dbs = tg.init_state(), tc.init_state(), []
        for blk in blocks:
            gs_d, gy = tg._pitchshift_fn_eager(gs_d, blk)
            cs_d, cy = tc._pitchshift_fn_eager(cs_d, blk)
            dbs.append(snr_db(cy.numpy(), gy.cpu().numpy()))
        dbs.append(snr_db(cs_d["prev_tail"].numpy(),
                          gs_d["prev_tail"].cpu().numpy()))
        _, gy = tg._pitchshift_streams_eager(tg.init_streams(16),
                                             tg.pqmf.as_tensor(streams))
        _, cy = tc._pitchshift_streams_eager(tc.init_streams(16),
                                             tc.pqmf.as_tensor(streams))
        dbs.append(snr_db(cy.numpy(), gy.cpu().numpy()))
    finally:
        S_ops.dft_matmul = dft_real
        cc.dense_synthesis_conv = syn_real
    flips, iso, inputs = [], [], []
    for (xg, _, _), (xc, kw, yc) in zip(k2_calls["cuda"], k2_calls["cpu"]):
        inputs.append(snr_db(xc.numpy(), xg.cpu().numpy()))
        flips.append((xg.cpu().to(torch.bfloat16)
                      != xc.to(torch.bfloat16)).float().mean().item())
        yg = cc.dense_synthesis_conv(
            xc.to(dev), tg.pqmf.hki, x_offset=kw["x_offset"],
            mxu_precision="default", pad=kw["pad"],
            bank=tg.pqmf.tc_banks["synthesis"])
        iso.append(snr_db(yc.numpy(), yg.cpu().numpy()))
    default_f32_dft_db = dbs
    print(f"  default with f32 DFT operands (diagnostic): 8 blocks, tail, "
          f"16 streams vs CPU: {[round(d, 1) for d in dbs]} dB; K2t's f32 "
          f"inputs card vs CPU: {[round(d, 1) for d in inputs]} dB, the "
          f"share whose bf16 rounding differs: "
          f"{[f'{f:.2e}' for f in flips]}; K2t on the CPU's inputs vs the "
          f"CPU: {[round(d, 1) for d in iso]} dB")
    assert len(iso) == 9 and min(iso) >= BAR_DB, iso

    # the offline path: PQMF, PQMFWrapper, its artifact and its CLI
    def counted(want_cc, want_pk, fn, *args):
        """Run fn(*args) and check the launches it made, kernel by kernel."""
        before = (dict(cc.LAUNCHES), dict(pk.LAUNCHES))
        out = fn(*args)
        torch.cuda.synchronize()
        for now, was, want in ((cc.LAUNCHES, before[0], want_cc),
                               (pk.LAUNCHES, before[1], want_pk)):
            delta = {k: now[k] - was[k] for k in now}
            assert delta == {**dict.fromkeys(now, 0), **want}, \
                (fn, delta, want)
        return out

    ana, syn, rt = {"analysis": 1}, {"synthesis": 1}, {"roundtrip": 1}
    both = {"analysis": 1, "synthesis": 1}
    stereo = _audio(16 * 4096, 4, batch=4).reshape(2, 2, -1)
    block_x = _audio(BLOCK, 5)[None]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    wav_in = os.path.join(tmp, "in.wav")
    write_wav(wav_in, _audio(10 * SR, 6) * 0.5, SR)
    finetuned = load_pretrained_bank("hk16_atten100_finetuned")
    off_gpu = PQMF(100, 16, device="cuda")
    st_gpu = PQMF(100, 16, n_channels=2, device="cuda")
    ft_gpu = PQMF(100, 16, device="cuda")
    ft_gpu.set_weights(finetuned)
    m32_gpu = PQMF(100, 32, device="cuda")
    wrap_gpu = PQMFWrapper(100, 16, BLOCK, device="cuda")
    cli_args = ["--input", wav_in, "--out_dir", os.path.join(tmp, "art"),
                "--audio_dir", tmp, "--device", "cuda"]

    cc.reset_launches()
    pk.reset_launches()
    with _plain_versions_refused():
        g_off = {
            "60 s forward": counted(ana, ana, off_gpu.forward, raw60),
            "60 s inverse": counted(syn, syn, off_gpu.inverse, sub60),
            "60 s roundtrip": counted(rt, rt, off_gpu.roundtrip, raw60),
            "stereo forward": counted(ana, ana, st_gpu.forward, stereo),
            "stereo roundtrip": counted(rt, rt, st_gpu.roundtrip, stereo),
            "fine-tuned 60 s roundtrip": counted(rt, rt, ft_gpu.roundtrip,
                                                 raw60),
            "M=32 roundtrip": counted(rt, rt, m32_gpu.roundtrip,
                                      stereo[0, :1]),
        }
        st_sub = g_off["stereo forward"]
        g_off["stereo inverse"] = counted(syn, syn, st_gpu.inverse, st_sub)
        g_wrap = counted(both, {}, wrap_gpu.process, block_x)
        save_artifact(wrap_gpu, os.path.join(tmp, "wrapper"))
        reloaded, _ = load_artifact(os.path.join(tmp, "wrapper"),
                                    device="cuda")
        g_reload = counted(both, {}, reloaded.process, block_x)
        # forward, inverse, process: two K1 + two K2
        rc = counted({"analysis": 2, "synthesis": 2}, {}, export_pqmf.main,
                     cli_args)
        assert rc == 0, rc
    off_launches, off_kernel_launches = dict(pk.LAUNCHES), dict(cc.LAUNCHES)
    print(f"offline-path launches: K4-K6 {off_launches}, "
          f"K1-K3 {off_kernel_launches}")

    off_cpu = PQMF(100, 16, device="cpu")
    st_cpu = PQMF(100, 16, n_channels=2, device="cpu")
    ft_cpu = PQMF(100, 16, device="cpu")
    ft_cpu.set_weights(finetuned)
    c_off = {
        "60 s forward": off_cpu.forward(sixty),
        "60 s inverse": off_cpu.inverse(sub60.cpu()),
        "60 s roundtrip": off_cpu.roundtrip(sixty),
        "stereo forward": st_cpu.forward(stereo),
        "stereo roundtrip": st_cpu.roundtrip(stereo),
        "stereo inverse": st_cpu.inverse(st_sub.cpu()),
        "fine-tuned 60 s roundtrip": ft_cpu.roundtrip(sixty),
        "M=32 roundtrip": PQMF(100, 32, device="cpu").roundtrip(
            stereo[0, :1]),
    }
    for what, ref in c_off.items():
        got = g_off[what].cpu()
        assert got.shape == ref.shape and torch.isfinite(got).all(), what
        torch.testing.assert_close(got, ref, **OFFLINE_TOL,
                                   msg=lambda m: f"{what}: {m}")
        print(f"  {what} vs CPU: max|err| "
              f"{(got - ref).abs().max().item():.3g}")
    off_db = aligned_roundtrip_snr_db(
        sixty, g_off["60 s roundtrip"][0, 0].cpu().numpy(), 0)
    ft_db = aligned_roundtrip_snr_db(
        sixty, g_off["fine-tuned 60 s roundtrip"][0, 0].cpu().numpy(), 0,
        edge_trim=1024)
    print(f"60 s offline round trip (K6) SNR at delay 0: {off_db:.4f} dB; "
          f"fine-tuned bank, edge_trim=1024: {ft_db:.4f} dB")
    assert abs(off_db - SNR_60S_DB[0]) <= SNR_60S_DB[1], off_db
    assert abs(ft_db - SNR_FINETUNED_DB[0]) <= SNR_FINETUNED_DB[1], ft_db

    # the offline path at each tier: K4-K6 over K1t-K3t on the 60 s signal,
    # counts zeroed just before and read just after, plain versions refused
    off_tier_launches, off_tier = {}, {}
    for tier in TIERS:
        og = PQMF(100, 16, precision=tier, device="cuda")
        oc = PQMF(100, 16, precision=tier, device="cpu")
        off_tier[tier] = og
        cc.reset_launches()
        pk.reset_launches()
        with _plain_versions_refused():
            t_sub = counted(ana, ana, og.forward, raw60)
            t_back = counted(syn, syn, og.inverse, sub60)
            t_rt = counted(rt, rt, og.roundtrip, raw60)
        off_tier_launches[tier] = dict(pk.LAUNCHES)
        c_sub = oc.forward(sixty)
        torch.testing.assert_close(t_sub.cpu(), c_sub, **OFFLINE_TOL)
        torch.testing.assert_close(t_back.cpu(), oc.inverse(sub60.cpu()),
                                   **OFFLINE_TOL)
        c_rt = oc.roundtrip(sixty)
        if tier == "bf16x3":
            torch.testing.assert_close(t_rt.cpu(), c_rt, **OFFLINE_TOL)
        else:
            _k3t_default_close(t_rt.cpu(), c_rt, c_sub, hi.cpu(),
                               "60 s offline round trip at default")
        t_db = aligned_roundtrip_snr_db(sixty, t_rt[0, 0].cpu().numpy(), 0)
        print(f"  offline {tier}: launches {off_tier_launches[tier]}, vs CPU "
              f"max|err| {(t_rt.cpu() - c_rt).abs().max().item():.3g}, 60 s "
              f"round trip SNR at delay 0 {t_db:.4f} dB")
        if tier == "bf16x3":
            assert abs(t_db - SNR_60S_DB[0]) <= SNR_60S_DB[1], t_db

    # the committed fine-tuned banks at M = 32 and 64 through
    # StreamingPQMF.roundtrip and PQMF.roundtrip (K6) on the 60 s signal, at
    # each tier: one K3 (K3t) launch each and no K1/K2, every plain version
    # refused, counts zeroed just before and read just after; at "highest"
    # equal to the CPU port, and the steady-state SNR (the readout of
    # parallel.training.roundtrip_snr) above the JAX package's floors at
    # "highest" and "bf16x3", >= 45 dB at "default"
    big_launches, big_k6_launches, big_db = {}, {}, {}
    for M in (32, 64):
        bank = load_pretrained_bank(f"hk{M}_atten100_finetuned")
        x_m = sixty[: len(sixty) // M * M][None, None]
        x_m_dev = torch.from_numpy(x_m).to(dev)
        for tier in ("highest",) + TIERS:
            sp_g = StreamingPQMF(100, M, precision=tier, device="cuda")
            pq_g = PQMF(100, M, precision=tier, device="cuda")
            sp_g.set_weights(bank)
            pq_g.set_weights(bank)
            cc.reset_launches()
            pk.reset_launches()
            with _plain_versions_refused():
                y_sp = counted(rt, {}, sp_g.roundtrip, x_m_dev)
                y_pq = counted(rt, rt, pq_g.roundtrip, x_m_dev)
            big_launches[M, tier] = cc.LAUNCHES["roundtrip"]
            big_k6_launches[M, tier] = pk.LAUNCHES["roundtrip"]
            # these very launches against their plain versions (K3/K3t
            # and K6 at the kernels' bars): the errors of the M = 32/64
            # rows of the kernels line include the path's own
            ka, ks = sp_g.hkf.shape[-1], sp_g.hki.shape[-1]
            apad, spad = centered_padding(ka), centered_padding(ks)
            hp_m, hi_m = pq_g.params["hk_poly"], pq_g.params["hk_ipoly"]
            for key, y, ref, sub, w_syn in [
                    (f"roundtrip_m{M}", y_sp,
                     cc.roundtrip_conv_plain(x_m_dev, sp_g.hkf, sp_g.hki, M,
                                             spad, tier, pad=apad),
                     cc.strided_analysis_conv(x_m_dev, sp_g.hkf, M, pad=apad),
                     sp_g.hki),
                    (f"polyphase_roundtrip_m{M}", y_pq,
                     pk.polyphase_roundtrip_plain(x_m_dev, hp_m, hi_m, tier),
                     pk.polyphase_analysis(x_m_dev, hp_m, pq_g._w2), hi_m)]:
                what = f"fine-tuned {key} 60 s"
                ref = ref.reshape(y.shape)
                if tier == "highest":
                    check(key, y, ref,
                          K12_TOL if key.startswith("r") else K6_TOL, what)
                else:
                    tcheck(key, tier, y, ref, what, sub, w_syn)
            for what, y, delay in [("StreamingPQMF", y_sp,
                                    sp_g.centered_delay),
                                   ("PQMF", y_pq, 0)]:
                assert y.shape == x_m.shape and torch.isfinite(y).all()
                db = aligned_roundtrip_snr_db(
                    x_m[0, 0], y[0, 0].cpu().numpy(), delay,
                    edge_trim=int(bank["hk"].shape[-1]))
                big_db[M, tier, what] = db
                need = {"highest": FINETUNED_FLOOR_DB[M],
                        "bf16x3": FINETUNED_FLOOR_DB[M],
                        "default": 45.0}[tier]
                assert db > need, (M, tier, what, db)
                if what == "StreamingPQMF" and (M, tier) in \
                        FINETUNED_EARLIER_DB:
                    want, tol = FINETUNED_EARLIER_DB[M, tier]
                    assert abs(db - want) <= tol, (M, tier, db, want)
            if tier == "highest":
                sp_c = StreamingPQMF(100, M, device="cpu")
                pq_c = PQMF(100, M, device="cpu")
                sp_c.set_weights(bank)
                pq_c.set_weights(bank)
                torch.testing.assert_close(y_sp.cpu(), sp_c.roundtrip(x_m),
                                           **OFFLINE_TOL)
                torch.testing.assert_close(y_pq.cpu(), pq_c.roundtrip(x_m),
                                           **OFFLINE_TOL)
            print(f"  fine-tuned M={M} [{tier}] 60 s: StreamingPQMF and "
                  f"PQMF round trips, {big_launches[M, tier]} K3 launches, "
                  f"no K1/K2; steady-state SNR "
                  f"{big_db[M, tier, 'StreamingPQMF']:.4f} / "
                  f"{big_db[M, tier, 'PQMF']:.4f} dB")

    wrap_cpu = PQMFWrapper(100, 16, BLOCK, device="cpu")
    c_wrap = wrap_cpu.process(block_x)
    for what, got in [("PQMFWrapper.process", g_wrap),
                      ("reloaded artifact", g_reload)]:
        err = 0.0
        for g, c in zip(got, c_wrap):
            torch.testing.assert_close(g.cpu(), c, **K12_TOL)
            err = max(err, (g.cpu() - c).abs().max().item())
        print(f"  {what} vs CPU: max|err| {err:.3g}")
    out_wav, out_sr = read_wav(os.path.join(tmp, "reconstruido.wav"))
    want_len = -(-10 * SR // BLOCK) * BLOCK
    assert out_sr == SR and out_wav.shape == (1, want_len), out_wav.shape
    assert np.isfinite(out_wav).all() and np.abs(out_wav).max() > 0.1
    print(f"  export_pqmf CLI: exit 0, {out_wav.shape[-1]} samples")
    shutil.rmtree(tmp)

    # the torchaudio variant: K1, every band's shift, K2 — one of each per
    # pitchshifter call, with every plain version made to raise
    ta = {dev_: PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR, TA_SHIFTS16,
                                        device=dev_)
          for dev_ in ("cuda", "cpu")}
    ta8 = {dev_: PQMFPitchShiftWrapperTA(100, 8, 2048, SR, TA_SHIFTS8,
                                         device=dev_)
           for dev_ in ("cuda", "cpu")}
    ta_file = {dev_: PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                             TA_SHIFTS16,
                                             max_buffer_size=None,
                                             device=dev_)
               for dev_ in ("cuda", "cpu")}
    ten = _audio(10 * SR, 10)
    ten_x = np.pad(ten, ((0, 0), (0, (-ten.shape[-1]) % BLOCK)))[None]
    ta_in = {
        "TA B=1 block": (ta, _audio(BLOCK, 7)[None]),
        "TA B=16 blocks": (ta, _audio(BLOCK, 8, batch=16)[:, None]),
        "TA 8 bands x 2048 (Tb=256)": (ta8, _audio(2048, 9, batch=2)[:, None]),
        "TA 10 s whole file": (ta_file, ten_x),
    }
    cc.reset_launches()
    pk.reset_launches()
    with _plain_versions_refused():
        g_ta = {what: counted(both, {}, w["cuda"].pitchshifter, x)
                for what, (w, x) in ta_in.items()}
        ta_sub = counted(ana, {}, ta["cuda"].forward, ta_in["TA B=1 block"][1])
        ta_back = counted(syn, {}, ta["cuda"].inverse, ta_sub)
    ta_launches = dict(cc.LAUNCHES)
    print(f"TA-path launches: {ta_launches}")
    assert ta_launches == {"analysis": 5, "synthesis": 5, "roundtrip": 0}
    for what, (w, x) in ta_in.items():
        got = g_ta[what]
        assert got.shape == x.shape and torch.isfinite(got).all(), what
        db = snr_db(w["cpu"].pitchshifter(x).numpy(), got.cpu().numpy())
        print(f"  {what}: {db:.1f} dB vs CPU")
        assert db >= BAR_DB, (what, db)
    # the TA block at each tier, against the CPU port at the same tier
    ta_tier = {}
    for tier in TIERS:
        ta_tier[tier] = {d: PQMFPitchShiftWrapperTA(
            100, N_BAND, BLOCK, SR, TA_SHIFTS16, precision=tier, device=d)
            for d in ("cuda", "cpu")}
        x = ta_in["TA B=1 block"][1]
        cc.reset_launches()
        with _plain_versions_refused():
            got = counted(both, {}, ta_tier[tier]["cuda"].pitchshifter, x)
        db = snr_db(ta_tier[tier]["cpu"].pitchshifter(x).numpy(),
                    got.cpu().numpy())
        own = snr_db(g_ta["TA B=1 block"].cpu().numpy(), got.cpu().numpy())
        bar = BAR_DB if tier == "bf16x3" else min(BAR_DB,
                                                   own + DEFAULT_MARGIN_DB)
        print(f"  TA B=1 block at {tier}: {db:.1f} dB vs CPU (bar {bar:.1f}; "
              f"the tier's own error {own:.1f} dB), launches "
              f"{dict(cc.LAUNCHES)}")
        assert db >= bar, (tier, db, bar)
    c_sub = ta["cpu"].forward(ta_in["TA B=1 block"][1])
    torch.testing.assert_close(ta_sub.cpu(), c_sub, **OFFLINE_TOL)
    torch.testing.assert_close(ta_back.cpu(), ta["cpu"].inverse(c_sub),
                               **OFFLINE_TOL)
    print("  TA forward / inverse vs CPU: within OFFLINE_TOL")

    # the block-streaming harness over the flagship: one K1 + one K2 per
    # block for the pitch stream, one K3 for all the round trips
    ola_in = {"stream_ola mono 10 s": _audio(10 * SR, 11),
              "stream_ola stereo 10 s": _audio(10 * SR, 12, batch=2)}
    ola_hop = OLA_BLOCK - OLA_OVERLAP
    n_blocks = -(-(10 * SR - OLA_BLOCK) // ola_hop) + 1
    g_ola = {}
    for what, x in ola_in.items():
        cc.reset_launches()
        with _plain_versions_refused():
            g_ola[what] = stream_ola(gpu, x, OLA_BLOCK, OLA_OVERLAP)
        torch.cuda.synchronize()
        ola_launches = dict(cc.LAUNCHES)
        print(f"{what} launches: {ola_launches}")
        assert ola_launches == {"analysis": n_blocks, "synthesis": n_blocks,
                                "roundtrip": 1}, ola_launches
        c_pitch, c_recon = stream_ola(cpu, x, OLA_BLOCK, OLA_OVERLAP)
        g_pitch, g_recon = (t.cpu() for t in g_ola[what])
        assert g_pitch.shape == x.shape and torch.isfinite(g_pitch).all()
        db = snr_db(c_pitch.numpy(), g_pitch.numpy())
        torch.testing.assert_close(g_recon, c_recon, **OFFLINE_TOL)
        print(f"  {what}: pitch {db:.1f} dB vs CPU, recon max|err| "
              f"{(g_recon - c_recon).abs().max().item():.3g}")
        assert db >= BAR_DB, (what, db)

    # the standalone shifters on 10 s (the TA shifter at the band rate)
    ta_sig = _audio(10 * SUB_SR, 13)
    shifters = {
        "TorchaudioPitchShift(2756, -5)": (TorchaudioPitchShift(SUB_SR, -5),
                                           ta_sig),
        "TorchaudioPitchShift(2756, 7)": (TorchaudioPitchShift(SUB_SR, 7),
                                          ta_sig),
        "PhaseVocoderPitchShift n_steps 4": (
            lambda x: PhaseVocoderPitchShift()(x, 4), ten),
        "ResamplePitchShift(4)": (ResamplePitchShift(4), ten),
    }
    for what, (fn, x) in shifters.items():
        got = fn(torch.from_numpy(x).to(dev))
        assert got.shape == x.shape and torch.isfinite(got).all(), what
        db = snr_db(fn(torch.from_numpy(x)).numpy(), got.cpu().numpy())
        print(f"  {what}: {db:.1f} dB vs CPU")
        assert db >= BAR_DB, (what, db)

    # the four new CLIs on a 10 s wav, every plain conv refused
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    wav_in = os.path.join(tmp, "in.wav")
    write_wav(wav_in, ten * 0.5, SR)
    shifts_arg = ["--shifts", ",".join(str(v) for v in SHIFTS16)]
    cli_runs = [
        ("vocoder", vocoder.main,
         [wav_in, os.path.join(tmp, "pvoc.wav"), "--n_steps", "4"],
         {"pvoc.wav": (1, 10 * SR)}),
        ("ps_torchaudio", ps_torchaudio.main,
         [wav_in, "--out_dir", os.path.join(tmp, "ta"), "--shifts",
          ",".join(str(v) for v in TA_SHIFTS16)],
         {"ta/ta_pitchshifted.wav": ten_x.shape[1:],
          "ta/reconstruido.wav": ten_x.shape[1:]}),
        ("blocks", blocks_cli.main,
         [wav_in, "--out_dir", os.path.join(tmp, "b"), *shifts_arg],
         {"b/blocktest_pitchshifter.wav": (1, 10 * SR),
          "b/nonblock_pitchshifter.wav": (1, 10 * SR)}),
        ("blocks --scan", blocks_cli.main,
         [wav_in, "--scan", "--out_dir", os.path.join(tmp, "s"),
          *shifts_arg],
         {"s/blocktest_pitchshifter.wav": (1, 10 * SR),
          "s/blocktest_recontructed.wav": (1, 10 * SR)}),
        ("export_pvoc", export_pvoc.main,
         ["--input", wav_in, "--out_dir", os.path.join(tmp, "art"),
          "--seed", "0", "--save_audio", "--audio_dir",
          os.path.join(tmp, "pv")],
         {"pv/phasevocoder.wav": ten_x.shape[1:]}),
    ]
    for name, main_fn, args, outputs in cli_runs:
        cc.reset_launches()
        with _plain_versions_refused():
            rc = main_fn([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        assert rc == 0, (name, rc)
        for rel, shape in outputs.items():
            y, sr_out = read_wav(os.path.join(tmp, rel))
            assert sr_out == SR and y.shape == tuple(shape), (rel, y.shape)
            assert np.isfinite(y).all() and np.abs(y).max() > 0.01, rel
        print(f"  CLI {name}: exit 0, launches {dict(cc.LAUNCHES)}")
    shutil.rmtree(tmp)

    # -- 3b. the ahead-of-time artifact: programs reloaded == live ----------
    print(json.dumps({"aot": _aot_phase(card)}))

    # -- 3c. the CUDA graphs against their eager bodies ----------------------
    print(json.dumps({"graphs": _graphs_phase(card)}))

    # -- 3d. the native C data layer ----------------------------------------
    print(json.dumps({"native": {"build_s": native_build_s,
                                 **_native_phase(card)}}))

    # -- 4. times, CUDA events after warm-up -----------------------------------
    cuda_ms, latency_ms = _events_ms, _host_ms

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
                      ("block [1,1,8704]", rand(1, 1, BLOCK + pad_a), 200),
                      ("stream_ola [215,1,4608]",
                       rand(215, 1, OLA_BLOCK + pad_a), 50)],
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
    cases.update({
        "polyphase_analysis": [("60 s [1,1,2646000]", raw60, 20),
                               ("block [1,1,8192]", rand(1, 1, BLOCK), 200)],
        "polyphase_synthesis": [("60 s [1,16,165375]", sub60, 20),
                                ("block [1,16,512]", rand(1, 16, 512), 200)],
        "polyphase_roundtrip": [("60 s [1,1,2646000]", raw60, 20),
                                ("block [1,1,8192]", rand(1, 1, BLOCK), 200)],
    })
    calls.update({
        "polyphase_analysis": (
            lambda x: pk.polyphase_analysis(x, hp, w2),
            lambda x: pk.polyphase_analysis_plain(x, hp)),
        "polyphase_synthesis": (
            lambda x: pk.polyphase_synthesis(x, hi),
            lambda x: pk.polyphase_synthesis_plain(x, hi)),
        "polyphase_roundtrip": (
            lambda x: pk.polyphase_roundtrip(x, hp, hi, w2),
            lambda x: pk.polyphase_roundtrip_plain(x, hp, hi)),
    })
    # one PyTorch call of the same product on the kernel's own (padded)
    # operands: cuDNN's f32 conv, TF32 off; timed here, never used by the
    # port. No single call computes K3 or K6.
    library = {
        "analysis": lambda x: F.conv1d(x, wa, stride=16),
        "synthesis": lambda x: F.conv1d(x, ws),
        "polyphase_analysis": lambda x: F.conv1d(x, w2, stride=16),
        "polyphase_synthesis": lambda x: F.conv1d(x, hi),
    }
    library_in = {  # K4's and K5's operands as their adapters pad them
        "polyphase_analysis": lambda x: F.pad(x, (256, 240)),
        "polyphase_synthesis": lambda x: F.pad(x, (15, 16)),
    }
    times, library_ms, bounds, row_ms = {}, {}, {}, {}
    print(f"times on {card} (CUDA events, ms per call):")
    for name, rows in cases.items():
        kern, plain = calls[name]
        for label, x, iters in rows:
            k, p, raw = pair_ms(lambda: kern(x), lambda: plain(x), iters)
            lib_ms = None
            if name in library:
                xl = library_in.get(name, lambda v: v)(x)
                lib_ms = min(cuda_ms(lambda: library[name](xl), iters)
                             for _ in range(2))
            row_ms[name, label.split(" [")[0]] = (
                k, p, *_bound(name, x, hkf, hki, hp))
            if name not in times:  # the first row is the headline
                times[name] = (k, p)
                library_ms[name] = lib_ms
                bounds[name] = _bound(name, x, hkf, hki, hp)
            lib_txt = "-" if lib_ms is None else f"{lib_ms:.4f}"
            print(f"  {name} {label}: kernel {k:.4f} plain {p:.4f} "
                  f"library {lib_txt} (p,k,k,p "
                  f"{[round(v, 4) for v in raw]})")
    for name, (bound_ms, by) in bounds.items():
        print(f"  {name}: bound {bound_ms:.5f} ms ({by}), kernel at "
              f"{bound_ms / times[name][0]:.1%} of it")

    # the tier kernels at the headline shapes, against their plain versions
    # at the same tier; bounds at the bf16 tensor-core peak
    # the kept (arranged) banks K1t/K2t read, built once as StreamingPQMF
    # and PQMF build them when weights are installed
    kept = {tier: {"wa": cc.arrange_tc_bank(wa, "analysis", tier),
                   "ws": cc.arrange_tc_bank(ws, "synthesis", tier),
                   "w2": cc.arrange_tc_bank(w2, "analysis", tier),
                   "hi": cc.arrange_tc_bank(hi, "synthesis", tier)}
            for tier in TIERS}

    def tier_calls(name, tier):
        kb = kept[tier]
        return {
            "analysis": (
                lambda x: cc.strided_analysis_conv(x, wa, 16,
                                                   mxu_precision=tier,
                                                   bank=kb["wa"]),
                lambda x: cc.analysis_conv_plain(x, wa, 16, precision=tier)),
            "synthesis": (
                lambda x: cc.dense_synthesis_conv(x, ws, True, -16, tier,
                                                  bank=kb["ws"]),
                lambda x: cc.synthesis_conv_plain(x, ws, True, -16, tier)),
            "roundtrip": (
                lambda x: cc.fused_roundtrip_conv(x, wa, ws, 16, (16, 16),
                                                  tier,
                                                  banks=(kb["wa"], kb["ws"])),
                lambda x: cc.roundtrip_conv_plain(x, wa, ws, 16, (16, 16),
                                                  tier)),
            "polyphase_analysis": (
                lambda x: pk.polyphase_analysis(x, hp, w2, mxu_precision=tier,
                                                tc_bank=kb["w2"]),
                lambda x: pk.polyphase_analysis_plain(x, hp, tier)),
            "polyphase_synthesis": (
                lambda x: pk.polyphase_synthesis(x, hi, tier, kb["hi"]),
                lambda x: pk.polyphase_synthesis_plain(x, hi, tier)),
            "polyphase_roundtrip": (
                lambda x: pk.polyphase_roundtrip(x, hp, hi, w2, tier,
                                                 (kb["w2"], kb["hi"])),
                lambda x: pk.polyphase_roundtrip_plain(x, hp, hi, tier)),
        }[name]

    def tier_library(name, tier, x):
        """One F.conv1d that computes K1t's / K2t's product at the tier (and
        K4t's / K5t's, on their adapters' padded operands), with cuDNN's
        TF32 on (bf16 values are exact in TF32): "default" conv(xh, wh);
        "bf16x3" one conv over channel-stacked operands, cat(xh, xl, xh)
        with cat(wh, wh, wl). Returns (the call on its prepared operands,
        its output in the kernel's layout)."""
        w = {"analysis": wa, "synthesis": ws, "polyphase_analysis": w2,
             "polyphase_synthesis": hi}[name]
        xin = {"analysis": lambda v: v,
               "synthesis": lambda v: fb_ops.reverse_half(v, -16),
               "polyphase_analysis": lambda v: F.pad(v, (256, 240)),
               "polyphase_synthesis": lambda v: F.pad(
                   fb_ops.reverse_half(v), (15, 16))}[name](x)
        xh, xl = fb_ops.split_bf16(xin)
        wh, wl = fb_ops.split_bf16(w)
        if tier == "bf16x3":
            xs, wst = torch.cat([xh, xl, xh], 1), torch.cat([wh, wh, wl], 1)
        else:
            xs, wst = xh, wh
        stride = 16 if name.endswith("analysis") else 1

        def call():
            return F.conv1d(xs, wst, stride=stride)

        with _tf32():
            y = call()
        if name.endswith("analysis"):
            y = fb_ops.reverse_half(y)
        else:
            y = torch.flip(y * 16, dims=(1,)).transpose(1, 2)
            if name == "polyphase_synthesis":
                y = y.reshape(y.shape[0], 1, -1)
        return call, y

    tier_times, tier_bounds = {}, {}
    for tier in TIERS:
        for name, rows in cases.items():
            kern, plain = tier_calls(name, tier)
            for label, x, iters in rows:
                k, p, raw = pair_ms(lambda: kern(x), lambda: plain(x), iters)
                if (name, tier) not in tier_times:  # the headline row
                    tier_times[name, tier] = (k, p)
                    tier_bounds[name, tier] = _bound(name, x, hkf, hki, hp,
                                                     tier)
                print(f"  {name} {label} [{tier}]: kernel {k:.4f} plain "
                      f"{p:.4f} (p,k,k,p {[round(v, 4) for v in raw]})")
            b_ms, by = tier_bounds[name, tier]
            print(f"  {name} [{tier}]: bound {b_ms:.5f} ms ({by}), kernel "
                  f"at {b_ms / tier_times[name, tier][0]:.1%} of it")
    # the library call at the tiers (K1t/K2t's products), at the headline
    # block shapes: events, device time, and its error against the plain
    # version; timed here, never called by the port
    tier_lib = {}
    for tier in TIERS:
        for name in ("analysis", "synthesis", "polyphase_analysis",
                     "polyphase_synthesis"):
            x = cases[name][0][1]
            n_it = 20 if name.startswith("polyphase") else 200
            call, y = tier_library(name, tier, x)
            ref = tier_calls(name, tier)[1](x)
            with _tf32():
                ms = min(cuda_ms(call, n_it) for _ in range(2))
                dev_lib = _device_us(call, 10 if n_it == 20 else 50)
            err = (y - ref).abs().max().item()
            tier_lib[name, tier] = (ms, dev_lib, err)
            print(f"  {name} [{tier}] library F.conv1d (TF32): {ms:.4f} ms, "
                  f"device {dev_lib:.2f} us, max|err| vs plain {err:.3g}")
    tier_dev_us = {}
    for tier in TIERS:
        for what, name, x in [
                ("K1t [1,1,8704]", "analysis", rand(1, 1, BLOCK + pad_a)),
                ("K1t [16,1,8704]", "analysis", rand(16, 1, BLOCK + pad_a)),
                ("K2t [1,16,544]", "synthesis", rand(1, 16, 544)),
                ("K2t [16,16,544]", "synthesis", rand(16, 16, 544)),
                ("K3t [1,1,8704]", "roundtrip", rand(1, 1, BLOCK + pad_a)),
                ("K3t [16,1,8704]", "roundtrip", rand(16, 1, BLOCK + pad_a)),
                ("K3t 60 s [1,1,2646512]", "roundtrip", x60),
                ("K6t 60 s [1,1,2646000]", "polyphase_roundtrip", raw60),
                ("K4t 60 s [1,1,2646000]", "polyphase_analysis", raw60),
                ("K5t 60 s [1,16,165375]", "polyphase_synthesis", sub60)]:
            fn = tier_calls(name, tier)[0]
            key = f"{what} {tier}"
            tier_dev_us[key] = _device_us(lambda: fn(x),
                                          10 if "60 s" in what else 50)
            print(f"  device time {key}: {tier_dev_us[key]:.2f} us "
                  "(profiler)")
        # the fused round trip beside its two halves run as two launches
        d = {k[:-len(tier) - 1]: v for k, v in tier_dev_us.items()
             if k.endswith(f" {tier}")}
        print(f"  K3t vs its halves [{tier}], device us: [1,1,8704] K3t "
              f"{d['K3t [1,1,8704]']:.2f}, K1t + K2t "
              f"{d['K1t [1,1,8704]'] + d['K2t [1,16,544]']:.2f}; [16,1,8704] "
              f"K3t {d['K3t [16,1,8704]']:.2f}, K1t + K2t "
              f"{d['K1t [16,1,8704]'] + d['K2t [16,16,544]']:.2f}; 60 s K3t "
              f"{d['K3t 60 s [1,1,2646512]']:.2f}, K6t "
              f"{d['K6t 60 s [1,1,2646000]']:.2f}, K4t + K5t "
              f"{d['K4t 60 s [1,1,2646000]'] + d['K5t 60 s [1,16,165375]']:.2f}")

    # K3 and K3t at M = 32 and 64 on the 60 s signal (the main path's
    # shape: the fine-tuned banks' round trips above) against their plain
    # versions, CUDA events; then K3 / K3t against its halves (K1 + K2, K1t
    # + K2t on the same input, two launches) at host blocks of B = 1 and 16
    # and on 60 s: device time (profiler) and CUDA events of both, each
    # shape's bound and the cluster plan: one "vs its halves" line each
    big_rows, big_k6_rows = {}, {}
    for M, (bw_a, bw_s) in big.items():
        ka, ks = bw_a.shape[-1], bw_s.shape[-1]
        x60m = F.pad(raw60, (ka // 2, ka // 2))
        xblk = rand(1, 1, BLOCK + ka - 1)
        xblk16 = rand(16, 1, BLOCK + ka - 1)
        for tier in ("highest",) + TIERS:
            kb = None if tier == "highest" else (
                cc.arrange_tc_bank(bw_a, "analysis", tier),
                cc.arrange_tc_bank(bw_s, "synthesis", tier))

            def k3(x, tier=tier, kb=kb, bw_a=bw_a, bw_s=bw_s, M=M):
                return cc.fused_roundtrip_conv(x, bw_a, bw_s, M, (16, 16),
                                               tier, banks=kb)

            def comp(x, tier=tier, kb=kb, bw_a=bw_a, bw_s=bw_s, M=M):
                sub = cc.strided_analysis_conv(
                    x, bw_a, M, mxu_precision=tier,
                    bank=None if kb is None else kb[0])
                return cc.dense_synthesis_conv(
                    sub, bw_s, True, 0, tier, (16, 16),
                    None if kb is None else kb[1])

            def plain(x, tier=tier, bw_a=bw_a, bw_s=bw_s, M=M):
                return cc.roundtrip_conv_plain(x, bw_a, bw_s, M, (16, 16),
                                               tier)

            k, p, raw = pair_ms(lambda: k3(x60m), lambda: plain(x60m), 20)
            row = {"ms": k, "plain_ms": p,
                   "composition_ms": min(cuda_ms(lambda: comp(x60m), 20)
                                         for _ in range(2)),
                   "device_us": _device_us(lambda: k3(x60m), 10),
                   "composition_device_us": _device_us(lambda: comp(x60m),
                                                       10)}
            row["bound_ms"], row["bound_by"] = _bound("roundtrip", x60m,
                                                      bw_a, bw_s, hp, tier)
            for tag, xb, it in (("block", xblk, 200), ("block_b16", xblk16,
                                                       100)):
                row[f"device_us_{tag}"] = _device_us(lambda: k3(xb), 50)
                row[f"composition_device_us_{tag}"] = _device_us(
                    lambda: comp(xb), 50)
                row[f"ms_{tag}"] = min(cuda_ms(lambda: k3(xb), it)
                                       for _ in range(2))
                row[f"composition_ms_{tag}"] = min(
                    cuda_ms(lambda: comp(xb), it) for _ in range(2))
                row[f"bound_ms_{tag}"] = _bound("roundtrip", xb, bw_a, bw_s,
                                                hp, tier)[0]
            plans = {}
            for tag, xb in (("block", xblk), ("block_b16", xblk16),
                            ("60s", x60m)):
                t_out = (xb.shape[-1] - ka) // M + 1 + 32 - ks + 1
                plans[tag] = cc.launch_plan(
                    "roundtrip", xb.shape[0], M, M, ka, ks, t_out,
                    n_sms=n_sms, precision=tier,
                    max_clusters=clusters[M, ka, ks, tier])
            row["plans"] = plans
            big_rows[M, tier] = row
            print(f"  K3 M={M} [{tier}] 60 s: kernel {k:.4f} plain {p:.4f} "
                  f"(p,k,k,p {[round(v, 4) for v in raw]}), K1 + K2 "
                  f"{row['composition_ms']:.4f} ms; bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}), kernel at "
                  f"{row['bound_ms'] / k:.1%} of it")
            name = "K3" if tier == "highest" else "K3t"
            halves = "K1 + K2" if tier == "highest" else "K1t + K2t"
            line = [f"  {name} vs its halves M={M} [{tier}] on {card}:"]
            for tag, label in (("block", f"[1,1,{BLOCK + ka - 1}]"),
                               ("block_b16", f"[16,1,{BLOCK + ka - 1}]")):
                line.append(
                    f"{label} device {row[f'device_us_{tag}']:.2f} vs "
                    f"{row[f'composition_device_us_{tag}']:.2f} us, events "
                    f"{row[f'ms_{tag}']:.4f} vs "
                    f"{row[f'composition_ms_{tag}']:.4f} ms, bound "
                    f"{row[f'bound_ms_{tag}'] * 1e3:.3f} us;")
            line.append(
                f"60 s device {row['device_us']:.2f} vs "
                f"{row['composition_device_us']:.2f} us, events "
                f"{k:.4f} vs {row['composition_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']});")
            line.append("plans (grid, threads, tile, sub-band steps, "
                        "cluster, smem): " + "; ".join(
                            f"{tag} {pl[0]}x{pl[3]} t{pl[4]} s{pl[5]} "
                            f"c{pl[6]} {pl[7]} B" for tag, pl in plans.items()))
            print(" ".join(line))
            # K6 (over K3) at the offline geometry, beside K4 + K5
            pq = offline[M]
            hp_m, hi_m, w2_m = (pq.params["hk_poly"], pq.params["hk_ipoly"],
                                pq._w2)
            tb = None if tier == "highest" else (
                cc.arrange_tc_bank(w2_m, "analysis", tier),
                cc.arrange_tc_bank(hi_m, "synthesis", tier))
            x6 = raw60[..., : raw60.shape[-1] // M * M]

            def k6(x, tier=tier, tb=tb, hp_m=hp_m, hi_m=hi_m, w2_m=w2_m):
                return pk.polyphase_roundtrip(x, hp_m, hi_m, w2_m, tier, tb)

            def k45(x, tier=tier, tb=tb, hp_m=hp_m, hi_m=hi_m, w2_m=w2_m):
                sub = pk.polyphase_analysis(
                    x, hp_m, w2_m, mxu_precision=tier,
                    tc_bank=None if tb is None else tb[0])
                return pk.polyphase_synthesis(sub, hi_m, tier,
                                              None if tb is None else tb[1])

            k, p, raw = pair_ms(
                lambda: k6(x6),
                lambda: pk.polyphase_roundtrip_plain(x6, hp_m, hi_m, tier),
                20)
            row6 = {"ms": k, "plain_ms": p,
                    "composition_ms": min(cuda_ms(lambda: k45(x6), 20)
                                          for _ in range(2)),
                    "device_us": _device_us(lambda: k6(x6), 10),
                    "composition_device_us": _device_us(lambda: k45(x6),
                                                        10)}
            row6["bound_ms"], row6["bound_by"] = _bound(
                "polyphase_roundtrip", x6, w2_m, hi_m, hp_m, tier)
            big_k6_rows[M, tier] = row6
            print(f"  K6 M={M} [{tier}] 60 s: kernel {k:.4f} plain {p:.4f}, "
                  f"K4 + K5 {row6['composition_ms']:.4f} ms; device "
                  f"{row6['device_us']:.2f} us vs K4 + K5 "
                  f"{row6['composition_device_us']:.2f} us; bound "
                  f"{row6['bound_ms']:.5f} ms ({row6['bound_by']})")

    # device time of K1-K3 at the block shapes (CUDA events there include
    # the host launch), of K4 at 60 s, and of the lone cuDNN conv of K1's
    # and K2's products beside them: "slower than the library call" is read
    # device time against device time
    dev_us, lib_dev_us = {}, {}
    for what, fn, x in [
            ("K1 [1,1,8704]", calls["analysis"][0], rand(1, 1, BLOCK + pad_a)),
            ("K1 [16,1,8704]", calls["analysis"][0],
             rand(16, 1, BLOCK + pad_a)),
            ("K2 [1,16,544]", calls["synthesis"][0], rand(1, 16, 544)),
            ("K2 [16,16,544]", calls["synthesis"][0], rand(16, 16, 544)),
            ("K3 [1,1,8704]", calls["roundtrip"][0],
             rand(1, 1, BLOCK + pad_a)),
            ("K3 [215,1,4608]", calls["roundtrip"][0],
             rand(215, 1, OLA_BLOCK + pad_a)),
            ("K4 60 s [1,1,2646000]", calls["polyphase_analysis"][0],
             raw60)]:
        dev_us[what] = _device_us(lambda: fn(x), 10 if "60 s" in what else 50)
        line = f"  device time {what}: {dev_us[what]:.2f} us"
        kind = {"K1": "analysis", "K2": "synthesis"}.get(what[:2])
        if kind:
            lib_dev_us[what] = _device_us(lambda: library[kind](x), 50)
            line += f", lone F.conv1d {lib_dev_us[what]:.2f} us"
        print(line + " (profiler)")

    state = {"s": gpu.init_state()}

    def flagship_step():
        state["s"], _ = gpu.pitchshift_fn(state["s"], blocks[1])

    block_ms = cuda_ms(flagship_step, 50)
    block_lat = latency_ms(flagship_step, 100)
    sstate = {"s": gpu.init_streams(16)}

    def streams_step():
        sstate["s"], _ = gpu.pitchshift_streams(sstate["s"], streams)

    streams_ms = cuda_ms(streams_step, 30)
    streams_lat = latency_ms(streams_step, 100)
    rt_ms = times["roundtrip"][0]
    off_rt_ms = cuda_ms(lambda: off_gpu.roundtrip(raw60), 20)
    wrap_ms = cuda_ms(lambda: wrap_gpu.process(block_x), 200)
    wrap_lat = latency_ms(lambda: wrap_gpu.process(block_x), 100)
    ta_x1 = torch.from_numpy(ta_in["TA B=1 block"][1]).to(dev)
    ta_x16 = torch.from_numpy(ta_in["TA B=16 blocks"][1]).to(dev)

    def ta_step1():
        ta["cuda"].pitchshifter(ta_x1)

    def ta_step16():
        ta["cuda"].pitchshifter(ta_x16)

    ta1_ms = cuda_ms(ta_step1, 50)
    ta1_lat = latency_ms(ta_step1, 100)
    ta16_ms = cuda_ms(ta_step16, 30)
    ta16_lat = latency_ms(ta_step16, 50)
    ola_x = torch.from_numpy(ola_in["stream_ola mono 10 s"]).to(dev)
    ola_lat = latency_ms(lambda: stream_ola(gpu, ola_x, OLA_BLOCK,
                                            OLA_OVERLAP), 5)
    ola2_x = torch.from_numpy(ola_in["stream_ola stereo 10 s"]).to(dev)
    ola2_lat = latency_ms(lambda: stream_ola(gpu, ola2_x, OLA_BLOCK,
                                             OLA_OVERLAP), 3)
    shifter_times = {}
    for what, (fn, x) in shifters.items():
        xd = torch.from_numpy(x).to(dev)
        shifter_times[what] = {"cuda_events_ms": cuda_ms(lambda: fn(xd), 5),
                               "latency_ms_median_p90_n":
                                   latency_ms(lambda: fn(xd), 5)}
    # the flagship's steps at default, state carried as above
    dstate = {"s": tier_gpu["default"].init_state(),
              "ss": tier_gpu["default"].init_streams(16)}

    def default_step():
        dstate["s"], _ = tier_gpu["default"].pitchshift_fn(dstate["s"],
                                                           blocks[1])

    def default_streams_step():
        dstate["ss"], _ = tier_gpu["default"].pitchshift_streams(
            dstate["ss"], streams)

    default_block_ms = cuda_ms(default_step, 50)
    summary = {
        "card": card,
        "kernel_device_us": dev_us,
        "library_device_us_block_shapes": lib_dev_us,
        "flagship_block_graph_ms": block_ms,
        "flagship_block_graph_rtf": (BLOCK / SR) / (block_ms / 1e3),
        "flagship_block_graph_latency_ms_median_p90_n": block_lat,
        "streams16_step_graph_ms": streams_ms,
        "streams16_graph_rtf": 16 * (BLOCK / SR) / (streams_ms / 1e3),
        "streams16_graph_latency_ms_median_p90_n": streams_lat,
        "roundtrip_60s_ms": rt_ms,
        "roundtrip_60s_rtf": 60.0 / (rt_ms / 1e3),
        "roundtrip_60s_snr_db": rt_db,
        "offline_roundtrip_60s_ms": off_rt_ms,
        "offline_roundtrip_60s_rtf": 60.0 / (off_rt_ms / 1e3),
        "offline_roundtrip_60s_snr_db": off_db,
        "finetuned_roundtrip_60s_snr_db_trim1024": ft_db,
        "pqmfwrapper_process_8192_ms": wrap_ms,
        "pqmfwrapper_process_8192_latency_ms_median_p90_n": wrap_lat,
        "ta_block_b1_graph_ms": ta1_ms,
        "ta_block_b1_graph_latency_ms_median_p90_n": ta1_lat,
        "ta_block_b16_graph_ms": ta16_ms,
        "ta_block_b16_graph_rtf": 16 * (BLOCK / SR) / (ta16_ms / 1e3),
        "ta_block_b16_graph_latency_ms_median_p90_n": ta16_lat,
        "stream_ola_mono_10s_graph_ms_median_p90_n": ola_lat,
        "stream_ola_mono_10s_graph_rtf": 10.0 / (ola_lat[0] / 1e3),
        "stream_ola_stereo_10s_graph_ms_median_p90_n": ola2_lat,
        "stream_ola_stereo_10s_graph_rtf": 10.0 / (ola2_lat[0] / 1e3),
        "shifters_10s": shifter_times,
        "tier_kernel_device_us": tier_dev_us,
        "flagship_block_default_graph_ms": default_block_ms,
        "streams16_step_default_graph_ms": cuda_ms(default_streams_step,
                                                   30),
        "roundtrip_60s_bf16x3_ms": cuda_ms(
            lambda: tier_gpu["bf16x3"].pqmf.roundtrip(raw60), 20),
        "roundtrip_60s_bf16x3_snr_db": rt_db_t,
        "offline_roundtrip_60s_bf16x3_ms": cuda_ms(
            lambda: off_tier["bf16x3"].roundtrip(raw60), 20),
        "flagship_tier_db_min": {t: min(v) for t, v in tier_db.items()},
        "flagship_default_f32_dft_db_min": min(default_f32_dft_db),
    }
    print(json.dumps(summary))

    # where a step's time goes: kernels by device time, and the share of
    # the step's wall time the card is busy at all
    # (the public entries, which replay CUDA graphs; phase 3c profiles the
    # eager bodies beside them)
    for label, step, ms in [("flagship block (graph)", flagship_step,
                             block_ms),
                            ("flagship block default (graph)", default_step,
                             default_block_ms),
                            ("16-stream step (graph)", streams_step,
                             streams_ms),
                            ("TA block B=1 (graph)", ta_step1, ta1_ms),
                            ("TA blocks B=16 (graph)", ta_step16, ta16_ms)]:
        print(json.dumps({"profile": label, **_profile(step, 10, ms)}))

    # -- 5. fine-tuning on the card ------------------------------------------
    print("fine-tuning (parallel/training.py):")
    print(json.dumps({"training": _training_phase(sixty, card)}))

    # -- 6. the (data, band) mesh ---------------------------------------------
    mesh_runs, shard_rows = _mesh_phase(card)
    print(json.dumps({"mesh": mesh_runs}))

    # -- 7. the entry points --------------------------------------------------
    print(f"the entry points (pqmf_tpu_torch/entry.py) on {card}:")
    entry_res = _entry_phase(card, block_ms, gpu)
    print(json.dumps({"entry": entry_res}))

    # (key, name, replaces, launches on its path: the flagship for K1-K3,
    # the offline path for K4-K6)
    rows = [
        ("analysis", "K1 strided_analysis_conv",
         "pqmf_tpu/kernels/cached_conv.py:408", launches["analysis"]),
        ("synthesis", "K2 dense_synthesis_conv",
         "pqmf_tpu/kernels/cached_conv.py:542", launches["synthesis"]),
        ("roundtrip", "K3 fused_roundtrip_conv",
         "pqmf_tpu/kernels/cached_conv.py:794", launches["roundtrip"]),
        ("polyphase_analysis", "K4 polyphase_analysis (over K1)",
         "pqmf_tpu/kernels/polyphase.py:168", off_launches["analysis"]),
        ("polyphase_synthesis", "K5 polyphase_synthesis (over K2)",
         "pqmf_tpu/kernels/polyphase.py:197", off_launches["synthesis"]),
        ("polyphase_roundtrip", "K6 polyphase_roundtrip (over K3)",
         "pqmf_tpu/kernels/polyphase.py:235", off_launches["roundtrip"]),
    ]
    # device times at the headline block shape (K1, K2) or 60 s (K4)
    headline_dev = {"analysis": "K1 [1,1,8704]", "synthesis": "K2 [1,16,544]",
                    "polyphase_analysis": "K4 60 s [1,1,2646000]"}
    kernels = [{"name": name, "route": "cuda",
                "source": "pqmf_tpu_torch/csrc/cached_conv.cu",
                "replaces": where, "launches": n, "max_abs_err": errs[k],
                "ms": times[k][0], "plain_ms": times[k][1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                "library_ms": library_ms[k],
                "device_us": dev_us.get(headline_dev.get(k)),
                "library_device_us": lib_dev_us.get(headline_dev.get(k))}
               for k, name, where, n in rows]
    # K3 at M = 16 at the shapes the serving paths give it: forward_fn's
    # block and stream_ola's batch of 215 blocks, one launch a call each
    k3 = kernels[2]
    for tag, label, n in (("block", "block", launches["roundtrip"]),
                          ("ola", "stream_ola", ola_launches["roundtrip"])):
        ms, plain, bound, by = row_ms["roundtrip", label]
        dk = "K3 [1,1,8704]" if tag == "block" else "K3 [215,1,4608]"
        k3.update({f"ms_{tag}": ms, f"plain_ms_{tag}": plain,
                   f"bound_ms_{tag}": bound, f"bound_by_{tag}": by,
                   f"device_us_{tag}": dev_us[dk], f"launches_{tag}": n})
        print(f"  {dk}: kernel {ms:.4f} ms (device {dev_us[dk]:.2f} us), "
              f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
              f"{n} launch a call")
    # the tier kernels: K1t-K3t with their launches on the flagship at the
    # tier, K4-K6 over them with theirs on the offline path at the tier
    tc_source = "pqmf_tpu_torch/csrc/cached_conv_tc.cu"
    tier_dev_key = {"analysis": "K1t [1,1,8704]",
                    "synthesis": "K2t [1,16,544]",
                    "roundtrip": "K3t 60 s [1,1,2646512]",
                    "polyphase_analysis": "K4t 60 s [1,1,2646000]",
                    "polyphase_synthesis": "K5t 60 s [1,16,165375]",
                    "polyphase_roundtrip": "K6t 60 s [1,1,2646000]"}
    for tier in TIERS:
        for k, name, where, _ in rows:
            t_name = name.replace("K1 ", "K1t ").replace("K2 ", "K2t ") \
                .replace("K3 ", "K3t ").replace("over K1", "over K1t") \
                .replace("over K2", "over K2t").replace("over K3", "over K3t")
            launches_k = (tier_launches[tier][k] if k in tier_launches[tier]
                          else off_tier_launches[tier][k.split("_")[1]])
            dk = tier_dev_key.get(k)
            kernels.append({
                "name": f"{t_name} [{tier}]", "route": "cuda",
                "source": tc_source, "replaces": where,
                "launches": launches_k, "max_abs_err": terrs[k, tier],
                "ms": tier_times[k, tier][0],
                "plain_ms": tier_times[k, tier][1],
                "bound_ms": tier_bounds[k, tier][0],
                "bound_by": tier_bounds[k, tier][1],
                # one TF32 F.conv1d computes K1t's, K2t's, K4t's and K5t's
                # products (on their padded operands); none computes the
                # fused round trip
                "library_ms": (tier_lib[k, tier][0] if (k, tier) in tier_lib
                               else None),
                "library_max_abs_err": (tier_lib[k, tier][2]
                                        if (k, tier) in tier_lib else None),
                "library_device_us": (tier_lib[k, tier][1]
                                      if (k, tier) in tier_lib else None),
                "device_us": tier_dev_us.get(f"{dk} {tier}") if dk else None,
                "device_us_b16": tier_dev_us.get(
                    {"analysis": "K1t [16,1,8704]",
                     "synthesis": "K2t [16,16,544]",
                     "roundtrip": "K3t [16,1,8704]"}.get(k, "") + f" {tier}"),
                "device_us_block": tier_dev_us.get(f"K3t [1,1,8704] {tier}")
                if k == "roundtrip" else None})
    # K3 and K3t at M = 32 and 64: launches from the fine-tuned banks' round
    # trips (StreamingPQMF and K6, one each a tier), times on 60 s
    for (M, tier), row in big_rows.items():
        key = f"roundtrip_m{M}"
        k3_name = "K3 fused_roundtrip_conv" if tier == "highest" else \
            "K3t fused_roundtrip_conv"
        kernels.append({
            "name": f"{k3_name} M={M} [{tier}]", "route": "cuda",
            "source": ("pqmf_tpu_torch/csrc/cached_conv.cu"
                       if tier == "highest" else tc_source),
            "replaces": "pqmf_tpu/kernels/cached_conv.py:794",
            "launches": big_launches[M, tier],
            "max_abs_err": errs[key] if tier == "highest"
            else terrs[key, tier],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call is the round trip
            "composition_ms": row["composition_ms"],
            "device_us": row["device_us"],
            "composition_device_us": row["composition_device_us"],
            **{k_: row[k_] for k_ in (
                "device_us_block", "composition_device_us_block",
                "ms_block", "composition_ms_block", "bound_ms_block",
                "device_us_block_b16", "composition_device_us_block_b16",
                "ms_block_b16", "composition_ms_block_b16",
                "bound_ms_block_b16")},
            "cluster": row["plans"]["60s"][6]})
    for (M, tier), row in big_k6_rows.items():
        over = "K3" if tier == "highest" else "K3t"
        kernels.append({
            "name": f"K6 polyphase_roundtrip (over {over}) M={M} [{tier}]",
            "route": "cuda",
            "source": ("pqmf_tpu_torch/csrc/cached_conv.cu"
                       if tier == "highest" else tc_source),
            "replaces": "pqmf_tpu/kernels/polyphase.py:235",
            "launches": big_k6_launches[M, tier],
            "max_abs_err": errs[f"polyphase_roundtrip_m{M}"]
            if tier == "highest" else terrs[f"polyphase_roundtrip_m{M}", tier],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "composition_ms": row["composition_ms"],
            "device_us": row["device_us"],
            "composition_device_us": row["composition_device_us"]})
    # K1/K2 (K1t/K2t) and K4/K5 at the band shards Mb = 8 and 4: launches
    # per rank on the mesh runs' main paths (2 and 4 ranks over gloo on the
    # card: the round trips at each tier, PQMF, the ShardedPitchShift
    # step), times at each kernel's headline shape on one shard
    mesh_path = {8: mesh_runs["gloo_1x2"][0], 4: mesh_runs["gloo_1x4"][0]}
    shard_meta = {
        "K1": ("K1 strided_analysis_conv", "analysis",
               "pqmf_tpu/kernels/cached_conv.py:408"),
        "K2": ("K2 dense_synthesis_conv", "synthesis",
               "pqmf_tpu/kernels/cached_conv.py:542"),
        "K4": ("K4 polyphase_analysis (over K1)", "analysis",
               "pqmf_tpu/kernels/polyphase.py:168"),
        "K5": ("K5 polyphase_synthesis (over K2)", "synthesis",
               "pqmf_tpu/kernels/polyphase.py:197")}
    for (name, Mb, tier), row in shard_rows.items():
        label, _, where = shard_meta[name]
        if tier != "highest":
            label = label.replace("K1 ", "K1t ").replace("K2 ", "K2t ")
        launches = sum(
            n[name] for what, n in mesh_path[Mb]["launches"].items()
            if tier in what or (tier == "highest" and "[" not in what))
        kernels.append({
            "name": f"{label} Mb={Mb} band shard [{tier}]", "route": "cuda",
            "source": ("pqmf_tpu_torch/csrc/cached_conv.cu"
                       if tier == "highest" else tc_source),
            "replaces": where, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_us": row["device_us"],
            "library_device_us": row["library_device_us"],
            "shape": row["shape"]})
    # K4 (K4t) without the sign mask: the same kernel with fuse_mask=False
    # (phase 7), its error beside the masked one
    no_mask = entry_res["k4_no_mask_max_abs_err"]
    for k in kernels:
        if k["name"].startswith("K4 polyphase_analysis") and \
                "band shard" not in k["name"]:
            tier = next((t for t in TIERS if f"[{t}]" in k["name"]),
                        "highest")
            k["max_abs_err_fuse_mask_false"] = no_mask[tier]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
