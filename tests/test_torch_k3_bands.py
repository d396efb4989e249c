"""The fused round trip at M = 32 and 64 — K3 (``roundtrip_cluster_kernel``,
``csrc/cached_conv.cu``) and K3t (``roundtrip_tc_kernel`` in clusters,
``csrc/cached_conv_tc.cu``), a thread-block cluster of M/8 blocks a tile
— against pqmf_tpu's fused Pallas round trip
(``fused_roundtrip_conv`` -> ``_fused_roundtrip_single``), which the JAX
package runs at these band counts and which runs here in interpret mode,
as its own tests run it.

- ``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip`` (K6) route through
  K3's wrapper at M = 32 and 64, with the designed and the committed
  fine-tuned banks (carried across with ``params_from_jax``), at
  ``highest`` and ``bf16x3`` against JAX at the same tier, and at
  ``default`` against the NumPy model of the tier
  (``tests/test_torch_precision.py``: JAX on the CPU computes that tier in
  f32).
- ``parallel.training.roundtrip_snr`` of the committed banks, the readout
  behind every fine-tuned-bank number, against the JAX package's.
- The gates (``fused_roundtrip_supported``, ``roundtrip_supported``)
  against the JAX gates, and the launch plans of K3/K3t at M = 32 and 64.
- K3's CUDA source itself, built with g++ against an emulated CUDA
  runtime (thread-block clusters, their barrier, distributed shared
  memory) and run on the CPU, against K3's plain version; what the card
  refuses raises.

Tolerance: the JAX package's kernel-vs-lax bar, atol=2e-5 / rtol=1e-4
(sums of up to 2112 f32 products taken in another order). On the CPU the
wrappers run their plain versions; the CUDA kernels are held against those
on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_precision import (assert_close_but_mid_flips, model_k1,
                                  model_k2)

import pqmf_tpu.kernels.cached_conv as jcc
import pqmf_tpu.kernels.polyphase as jpk
from pqmf_tpu import PQMF as JPQMF
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.parallel.training import load_pretrained_bank as j_bank
from pqmf_tpu.streaming import StreamingPQMF as JStreamingPQMF
from pqmf_tpu.streaming import centered_padding
from pqmf_tpu.streaming import kernels_from_params as j_kernels
from pqmf_tpu.utils.metrics import aligned_roundtrip_snr_db as j_snr_db
from pqmf_tpu_torch import PQMF, StreamingPQMF
from pqmf_tpu_torch.convert import params_from_jax
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.parallel import training
from pqmf_tpu_torch.utils.metrics import aligned_roundtrip_snr_db

TOL = dict(atol=2e-5, rtol=1e-4)
BANKS = ("designed", "finetuned")
TIERS = ("highest", "bf16x3", "default")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, **TOL)


def _params(M, bank):
    """The JAX params of the bank (None: designed)."""
    return None if bank == "designed" else j_bank(
        f"hk{M}_atten100_finetuned")


def _pair(M, bank, precision, offline=False):
    """(JAX, port) filterbanks of one bank at one tier."""
    params = _params(M, bank)
    if offline:
        jp, tp = JPQMF(100, M, precision=precision, use_pallas=True), \
            PQMF(100, M, precision=precision, device="cpu")
    else:
        jp = JStreamingPQMF(100, M, precision=precision, use_pallas=True)
        tp = StreamingPQMF(100, M, precision=precision, device="cpu")
    if params is not None:
        if offline:
            jp.set_weights(params)
        else:
            jp.set_weights(params, *j_kernels(params))
        tp.set_weights(params_from_jax(params))
    return jp, tp


@pytest.fixture
def routes(monkeypatch):
    """Counts of the fused calls on both sides, and the port's composition
    (K1, K2) made to raise: the round trip must take K3's wrapper."""
    calls = {"jax": 0, "port": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def counted(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)

    spy(jcc, "fused_roundtrip_conv", "jax")
    spy(cc, "fused_roundtrip_conv", "port")

    def refuse(*args, **kwargs):
        raise AssertionError("the round trip ran K1 + K2")

    monkeypatch.setattr(cc, "strided_analysis_conv", refuse)
    monkeypatch.setattr(cc, "dense_synthesis_conv", refuse)
    return calls


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("M", [32, 64])
def test_streaming_roundtrip_matches_jax_fused(M, B, bank, routes):
    """``StreamingPQMF.roundtrip`` against the JAX package's one fused
    Pallas call, each taken once."""
    jp, tp = _pair(M, bank, "highest")
    x = _rand(M + B, B, 1, M * 300)
    ref = np.asarray(jp.roundtrip(x))
    got = tp.roundtrip(x)
    assert routes == {"jax": 1, "port": 1}
    _close(got, ref)


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("M", [32, 64])
def test_streaming_roundtrip_tiers(M, tier, bank, routes):
    """At ``bf16x3`` against JAX's fused call at ``mxu_precision="bf16x3"``;
    at ``default`` against the tier's NumPy model (JAX on the CPU computes
    that tier in f32), within its mid-flip bound."""
    jp, tp = _pair(M, bank, tier)
    x = _rand(3 * M, 2, 1, M * 200)
    got = tp.roundtrip(x)
    assert routes["port"] == 1
    if tier == "bf16x3":
        _close(got, jp.roundtrip(x))
        assert routes["jax"] == 1
        return
    hkf, hki = tp.hkf.numpy(), tp.hki.numpy()
    sub = model_k1(x, hkf, M, tier, centered_padding(hkf.shape[-1]))
    sl, sr = centered_padding(hki.shape[-1])
    want = model_k2(np.pad(sub, ((0, 0), (0, 0), (sl, sr))), hki, tier,
                    x_offset=-sl).reshape(2, 1, -1)
    assert_close_but_mid_flips(got, want, sub, hki)


@pytest.mark.parametrize("tier", ["highest", "bf16x3"])
@pytest.mark.parametrize("M", [32, 64])
def test_pqmf_roundtrip_finetuned_matches_pallas(M, tier, monkeypatch):
    """K6 with the committed fine-tuned bank against the JAX PQMF's
    polyphase round trip on its fused Pallas call, both taken."""
    calls = {"jax": 0, "port": 0}
    for mod, key in ((jpk, "jax"), (pk, "port")):
        real = mod.polyphase_roundtrip

        def counted(*args, _real=real, _key=key, **kwargs):
            calls[_key] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, "polyphase_roundtrip", counted)
    jp, tp = _pair(M, "finetuned", tier, offline=True)
    x = _rand(M, 2, 1, M * 40)
    _close(tp.roundtrip(x), jp.roundtrip(x))
    assert calls == {"jax": 1, "port": 1}


def _bench_signal(n):
    """bench.py's test signal (a 440 Hz sine plus seeded noise)."""
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / 44100
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n).astype(np.float32)).astype(
                np.float32)


@pytest.mark.parametrize("M", [32, 64])
def test_roundtrip_snr_matches_jax(M):
    """``training.roundtrip_snr`` of a committed bank — the readout behind
    every fine-tuned-bank number, one K3 launch on the card — against the
    same readout through the JAX package's fused round trip. The port's
    K3 route reads its own K1 + K2 composition's SNR to 0.01 dB. Against
    JAX the bar is 0.1 dB: at 104-108 dB both readouts are float32, and
    the CPU convs' round-off (oneDNN's against XLA's) puts the port 0.06
    to 0.08 dB under JAX at every length from 1.5 s to 60 s of this
    signal, fused or composed alike (0.03 dB at M = 16,
    ``tests/test_torch_training.py``)."""
    params = j_bank(f"hk{M}_atten100_finetuned")
    x = _bench_signal(M * 2000)
    got = training.roundtrip_snr(params_from_jax(params), 100, M, x,
                                 device="cpu")
    sp = StreamingPQMF(100, M, device="cpu")
    sp.set_weights(params_from_jax(params))
    composed = aligned_roundtrip_snr_db(
        x, sp.inverse(sp.forward(x[None, None]))[0, 0].numpy(),
        sp.centered_delay, edge_trim=int(params["hk"].shape[-1]))
    assert abs(got - composed) <= 0.01, (got, composed)
    jp = JStreamingPQMF(100, M, use_pallas=True)
    jp.set_weights(params, *j_kernels(params))
    y = np.asarray(jp.roundtrip(x[None, None]))[0, 0]
    want = j_snr_db(x, y, jp.centered_delay,
                    edge_trim=int(params["hk"].shape[-1]))
    assert want > 100, want
    assert abs(got - want) <= 0.1, (got, want)


def _banks_of(M):
    """(Ka, Ks, L) of the designed bank and, where one is committed, the
    fine-tuned bank of M bands."""
    out = []
    for params in [jfb.build_filterbank(100, M)] + (
            [j_bank(f"hk{M}_atten100_finetuned")] if M >= 8 else []):
        hkf, hki = j_kernels(params)
        out.append((hkf.shape[-1], hki.shape[-1],
                    params["hk_ipoly"].shape[-1]))
    return out


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
def test_gates_match_jax(M):
    """K3's gate, and K6's over it, accept every geometry the JAX gates
    accept, at every tier, for the designed and the committed banks: M = 8
    to 64. At M = 2 and 4 the JAX gates refuse for one reason only, that a
    128-lane group (128 / M sub-band steps) does not divide the synthesis
    left pad, a TPU layout constraint; K3 takes them."""
    for Ka, Ks, L in _banks_of(M):
        sl = centered_padding(Ks)[0]
        j_stream, j_offline = (jcc.fused_roundtrip_supported(M, sl),
                               jpk.roundtrip_supported(M, L))
        lane_only = not j_stream and jcc.fused_roundtrip_supported(M, 0)
        assert lane_only == (M in (2, 4))
        assert j_offline == j_stream
        for tier in TIERS:
            assert cc.fused_roundtrip_supported(M, Ka, Ks, tier) == (
                j_stream or lane_only), (M, Ka, Ks, tier)
            assert pk.roundtrip_supported(M, L * M, L, tier) == (
                j_offline or lane_only), (M, L, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("B,samples", [(1, 8192), (16, 8192), (1, 60 * 44100)])
@pytest.mark.parametrize("M", [32, 64])
def test_plans_fit(M, B, samples, tier):
    """K3's and K3t's plans at M = 32 and 64, for a host block (one stream
    and 16) and for 60 s: one thread-block cluster of M/8 blocks a tile,
    within a block's shared memory and its gate, tiles that cover every
    output step, one a cluster for a host block and as many persistent
    clusters as the card holds (here the nominal n_sms // C) on a whole
    file."""
    Ka, Ks = 32 * M + 1, 33
    T_out = samples // M
    gx, gy, gz, threads, tile, n_sub, C, smem = cc.launch_plan(
        "roundtrip", B, M, M, Ka, Ks, T_out, precision=tier)
    gate = cc.smem_bytes("roundtrip", M, M, Ka, Ks, tier)
    assert smem <= gate <= cc.SMEM_LIMIT
    # K3: blocks of 8 bands; K3t: blocks of a channel block (16 channels)
    # where its slice of both banks fits, else of 8 (M = 64, bf16x3)
    wide = tier != "highest" and (M, tier) != (64, "bf16x3")
    assert (gy, gz, C) == (1, 1, M // 16 if wide else M // 8)
    assert gx % C == 0 and n_sub >= tile + Ks - 1
    tiles = B * -(-T_out // tile)
    if samples == 8192:
        assert tile in (16, 32, 64) and gx == tiles * C
    else:
        assert gx == cc.N_SMS // C * C and gx // C < tiles
        # K3t at M = 64: its bank slices (134 KB) leave room for 128
        # sub-band steps; the others keep 256
        assert (tile, n_sub) == ((96, 128) if M == 64 and tier != "highest"
                                 else (224, 256))
    # highest: one thread a thread tile of 2 bands x 8 steps (whole files)
    # or 1 x 4 (host blocks) of the block's 8 bands; the tiers: 8 warps
    want = 8 // 2 * n_sub // 8 if samples > 8192 else 8 * n_sub // 4
    assert threads == (-(-want // 32) * 32 if tier == "highest" else 256)
    assert threads <= 256


def test_composition_never_runs_past_m16_on_cpu_routes(monkeypatch):
    """On the CPU too the M = 32 and 64 round trips take K3's wrapper and
    K6 (their plain versions), never K1 + K2 or K4 + K5 — the routes the
    card takes."""
    def refuse(*args, **kwargs):
        raise AssertionError("the round trip ran the composition")

    for mod, name in ((cc, "strided_analysis_conv"),
                      (cc, "dense_synthesis_conv"),
                      (pk, "polyphase_analysis"),
                      (pk, "polyphase_synthesis")):
        monkeypatch.setattr(mod, name, refuse)
    for M in (32, 64):
        x = _rand(M, 1, 1, M * 64)
        for tier in TIERS:
            for fb in (StreamingPQMF(100, M, precision=tier, device="cpu"),
                       PQMF(100, M, precision=tier, device="cpu")):
                assert fb.roundtrip(x).shape == x.shape


# ---------------------------------------------------------------------------
# the CUDA source of K3 itself, run on the CPU under an emulated runtime
# ---------------------------------------------------------------------------

# The CUDA runtime as csrc/cached_conv.cu uses it, emulated for g++: one OS
# thread per CUDA thread, a real barrier for __syncthreads, blocks one after
# another except the blocks of one thread-block cluster, which run together
# with a cluster barrier over all their threads (barrier.cluster.arrive /
# .wait, which must alternate in every thread and end in a wait), shared
# memory NaN-filled per block (a read of anything the kernel did not write
# shows in the output) and NaN-filled again when the block's last thread
# exits (a peer reading it later shows too), mapa into a peer block's shared
# memory, and each cp.async copy held back until its thread's
# cp.async.wait_group lets its group land.  cudaLaunchKernelEx refuses what
# a card refuses (clusters past 8 blocks, a grid not of whole clusters,
# more than 227 KB of shared memory, 1024 threads);
# cudaOccupancyMaxActiveClusters answers EMU_CLUSTERS, else EMU_SMS / C.
_EMU_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16,
       cudaLaunchAttributeClusterDimension = 4 };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
struct cudaLaunchAttribute { int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val; };
struct cudaLaunchConfig_t { dim3 gridDim, blockDim; size_t dynamicSmemBytes;
  cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs; };
inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local char* emu_smem = nullptr;
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
struct EmuBarrier {  // a barrier some thread never reaches aborts in 60 s
  std::mutex m; std::condition_variable cv; int n = 0, count = 0; long gen = 0;
  long arrive() {
    std::lock_guard<std::mutex> l(m);
    const long g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    return g;
  }
  void wait_past(long g, const char* what) {
    std::unique_lock<std::mutex> l(m);
    if (!cv.wait_for(l, std::chrono::seconds(60), [&] { return g != gen; })) {
      std::fprintf(stderr, "%s: a thread never arrived\n", what);
      std::abort();
    }
  }
  void wait() { wait_past(arrive(), "__syncthreads"); }
};
struct EmuCluster {
  std::vector<std::vector<char>> smem;
  std::vector<EmuBarrier> block_bar;
  std::vector<std::atomic<int>> live;
  EmuBarrier bar;
  EmuCluster(int C, size_t bytes, int threads)
      : smem(C, std::vector<char>(bytes + 16, (char)0xFF)), block_bar(C),
        live(C) {
    for (auto& b : block_bar) b.n = threads;
    for (auto& l : live) l = threads;
    bar.n = C * threads;
  }
};
inline thread_local EmuBarrier* emu_bar = nullptr;
inline thread_local EmuCluster* emu_cl = nullptr;
inline thread_local int emu_rank = 0;
inline thread_local long emu_cl_gen = -1;
inline void __syncthreads() { emu_bar->wait(); }
inline void emu_cluster_arrive() {
  if (emu_cl_gen >= 0) {
    std::fprintf(stderr, "barrier.cluster.arrive twice\n");
    std::abort();
  }
  emu_cl_gen = emu_cl->bar.arrive();
}
inline void emu_cluster_wait() {
  if (emu_cl_gen < 0) {
    std::fprintf(stderr, "barrier.cluster.wait without an arrive\n");
    std::abort();
  }
  emu_cl->bar.wait_past(emu_cl_gen, "barrier.cluster");
  emu_cl_gen = -1;
}
inline const void* emu_mapa(const void* p, int rank) {
  const long off = (const char*)p - emu_smem;
  if (off < 0 || off >= (long)emu_cl->smem[0].size() || rank < 0 ||
      rank >= (int)emu_cl->smem.size()) {
    std::fprintf(stderr, "mapa outside the cluster's shared memory\n");
    std::abort();
  }
  return emu_cl->smem[rank].data() + off;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
using std::fmaf; using std::max; using std::min;
struct EmuCopy { void* dst; const void* src; int size, bytes; };
inline thread_local std::vector<EmuCopy> emu_pending;
inline thread_local std::deque<std::vector<EmuCopy>> emu_groups;
inline void emu_cp(void* dst, const void* src, int size, int bytes) {
  emu_pending.push_back({dst, src, size, bytes}); }
inline void emu_commit() {
  emu_groups.push_back(emu_pending); emu_pending.clear(); }
inline void emu_wait(int n) {
  while ((int)emu_groups.size() > n) {
    for (const EmuCopy& c : emu_groups.front()) {
      std::memset(c.dst, 0, c.size);
      if (c.bytes) std::memcpy(c.dst, c.src, c.bytes);
    }
    emu_groups.pop_front();
  }
}
template <typename F>
void emu_run(dim3 grid, int threads, size_t smem, int C, F f) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x0 = 0; x0 < grid.x; x0 += C) {
        EmuCluster cl(C, smem, threads);
        std::vector<std::thread> ts;
        for (int r = 0; r < C; ++r)
          for (int t = 0; t < threads; ++t)
            ts.emplace_back([&, r, t] {
              threadIdx = {(unsigned)t, 0, 0};
              blockIdx = {x0 + r, y, z};
              emu_smem = cl.smem[r].data();
              emu_bar = &cl.block_bar[r];
              emu_cl = &cl;
              emu_rank = r;
              f();
              if (!emu_pending.empty() || !emu_groups.empty()) {
                std::fprintf(stderr, "a copy outlived its block\n");
                std::abort();
              }
              if (emu_cl_gen >= 0) {
                std::fprintf(stderr, "a block exited between a cluster "
                             "arrive and its wait\n");
                std::abort();
              }
              if (--cl.live[r] == 0)  // the block is gone: its memory too
                std::fill(cl.smem[r].begin(), cl.smem[r].end(), (char)0xFF);
            });
        for (std::thread& th : ts) th.join();
      }
}
template <typename F>
void emu_launch(dim3 grid, int threads, size_t smem, cudaStream_t, F f) {
  emu_run(grid, threads, smem, 1, f);
}
inline int emu_cluster_of(const cudaLaunchConfig_t* cfg) {
  int C = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      C = (int)(cfg->attrs[i].val.clusterDim.x * cfg->attrs[i].val.clusterDim.y
                * cfg->attrs[i].val.clusterDim.z);
  return C;
}
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...),
                               A&&... args) {
  const int C = emu_cluster_of(cfg);
  if (C < 1 || C > 8 || cfg->gridDim.x % C || cfg->gridDim.x == 0 ||
      cfg->dynamicSmemBytes > 232448 || cfg->blockDim.x > 1024)
    return cudaErrorInvalidConfiguration;
  emu_run(cfg->gridDim, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, C,
          [&] { k(args...); });
  return 0;
}
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) {
  return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  const char* e = std::getenv("EMU_SMS");
  *v = e ? std::atoi(e) : 132;
  return 0;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K,
                                           const cudaLaunchConfig_t* cfg) {
  const char* e = std::getenv("EMU_CLUSTERS");
  int sms = 0;
  cudaDeviceGetAttribute(&sms, 0, 0);
  *n = e ? std::atoi(e) : sms / emu_cluster_of(cfg);
  return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
"""


def _emulated_source(src: str) -> str:
    """The CUDA source for the emulated runtime: each ``asm volatile``
    (cp.async and its groups, the cluster barrier, mapa) becomes an
    emulation call, each ``k<<<cfg>>>
    (args)`` an ``emu_launch(cfg, [&] { k(args); })``, each dynamic shared
    array a view of the block's emulated shared memory."""
    def closing(s, k):  # the index past the ')' matching the '(' before k
        depth = 1
        while depth:
            depth += {"(": 1, ")": -1}.get(s[k], 0)
            k += 1
        return k

    calls = [("cp.async.ca.shared.global", "emu_cp(dst, src, 4, bytes);"),
             ("cp.async.cg.shared.global", "emu_cp(dst, src, 16, bytes);"),
             ("cp.async.commit_group", "emu_commit();"),
             ("cp.async.wait_group %0", "emu_wait(N);"),
             ("barrier.cluster.arrive", "emu_cluster_arrive();"),
             ("barrier.cluster.wait", "emu_cluster_wait();"),
             ("mapa.u64", "r = (unsigned long long)emu_mapa(p, rank);")]
    out, i = [], 0
    while (j := src.find("asm volatile(", i)) >= 0:
        k = closing(src, j + len("asm volatile("))
        out += [src[i:j], next(c for t, c in calls if t in src[j:k])]
        i = k + 1  # the ';'
    src = "".join(out) + src[i:]
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        s = src.rindex("\n", 0, j) + 1
        s += len(src[s:j]) - len(src[s:j].lstrip())
        e = src.index(">>>", j)
        k = closing(src, e + 4)
        out += [src[i:s], f"emu_launch({src[j + 3:e]}, [&] {{ "
                          f"{src[s:j]}({src[e + 4:k - 1]}); }})"]
        i = k
    src = "".join(out) + src[i:]
    return re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", src)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/cached_conv.cu`` built with g++ against the emulated runtime,
    bound with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated CUDA source")
    d = tmp_path_factory.mktemp("emulated")
    (d / "cuda_runtime.h").write_text(_EMU_RUNTIME)
    src = Path(cc.__file__).parent.parent / "csrc" / "cached_conv.cu"
    (d / "k.cpp").write_text(_emulated_source(src.read_text()))
    subprocess.run([gxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-w",
                    "-pthread", f"-I{d}", f"-I{src.parent}", "-o",
                    str(d / "k.so"), str(d / "k.cpp")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pqmf_roundtrip_conv.argtypes = [p, p, p, p] + [i] * 9 + [p]
    lib.pqmf_launch_plan.argtypes = [i] * 9 + [p]
    lib.pqmf_rt_max_clusters.argtypes = [i, i, i, p]
    return lib


@pytest.mark.parametrize("M,B,steps,n_sms,clusters,syn_pad", [
    (16, 2, 300, 132, None, (16, 16)),   # M <= 16: the emulation's check
    (32, 2, 300, 132, None, (16, 16)),   # one cluster a tile of 16 steps
    (32, 4, 256, 132, None, (0, 40)),    # tiles of 64 steps
    (32, 3, 470, 2, 1, (3, 0)),          # one persistent cluster, 224-step tiles
    (64, 3, 90, 132, None, (16, 17)),
    (64, 1, 700, 2, 2, (16, 16)),        # two persistent clusters
    # the cluster plans at host blocks of B = 1, 3, 16 and a whole file
    (32, 1, 256, 132, None, (16, 16)),
    (64, 3, 128, 132, None, (16, 16)),
    (64, 16, 128, 132, None, (16, 16)),
    (32, 1, 1200, 4, 2, (16, 16)),
    (64, 2, 600, 4, 3, (16, 16))])
def test_k3_source_emulated_matches_plain(emulated, monkeypatch, M, B, steps,
                                          n_sms, clusters, syn_pad):
    """The CUDA source of K3 (at M = 32 and 64 ``roundtrip_cluster_kernel``:
    the bank slices and their transposed copies, the cp.async window, the
    cluster barriers, the sub-band tile read from every block of the
    cluster, both plans) executed on the CPU, on a card of ``n_sms`` SMs
    holding ``clusters`` whole-file clusters, against K3's plain version
    within the K1/K2 bar; every output written and finite (shared memory
    starts as NaN, and a block's is NaN again once it exits)."""
    monkeypatch.setenv("EMU_SMS", str(n_sms))
    if clusters is not None:
        monkeypatch.setenv("EMU_CLUSTERS", str(clusters))
    sp = StreamingPQMF(100, M, device="cpu")
    wa, ws = sp.hkf.contiguous(), sp.hki.contiguous()
    Ka, Ks = wa.shape[-1], ws.shape[-1]
    pad = (Ka // 2, Ka // 2)
    x = torch.from_numpy(_rand(M + B + n_sms, B, 1, M * steps + 5))
    T_ana = (sum(pad) + x.shape[-1] - Ka) // M + 1
    T_out = syn_pad[0] + T_ana + syn_pad[1] - Ks + 1
    out = torch.full((B, T_out, M), float("nan"))
    assert emulated.pqmf_roundtrip_conv(
        x.data_ptr(), wa.data_ptr(), ws.data_ptr(), out.data_ptr(), B,
        x.shape[-1], M, Ka, Ks, T_ana, T_out, pad[0], syn_pad[0], None) == 0
    assert torch.isfinite(out).all()
    plan = cc.launch_plan("roundtrip", B, M, M, Ka, Ks, T_out, n_sms=n_sms,
                          max_clusters=clusters)
    assert (plan[4] > 64) == (clusters is not None or M == 16)
    assert plan[6] == (1 if M == 16 else M // 8)
    _close(out, cc.roundtrip_conv_plain(x, wa, ws, M, syn_pad, pad=pad))


@pytest.mark.parametrize("case", ["no_cluster_fits", "smem", "bands"])
def test_k3_source_refuses_what_the_card_cannot_take(emulated, monkeypatch,
                                                    case):
    """A launch the card cannot take returns its error from the C entry,
    which the wrapper raises (``_launch``), and writes nothing: no cluster
    of the whole-file tile fits (cudaOccupancyMaxActiveClusters answers 0),
    an analysis bank whose slice leaves a block's shared memory, a band
    count with no cluster kernel. Nothing falls back to another kernel."""
    M = 32
    monkeypatch.setenv("EMU_SMS", "132")
    monkeypatch.setenv("EMU_CLUSTERS", "0")
    Ka, Ks = {"no_cluster_fits": (1025, 33), "smem": (32 * 300 + 1, 33),
              "bands": (1025, 33)}[case]
    Mk = 48 if case == "bands" else M
    T_ana = 132 * 16 * 16 + 1  # a whole file: the persistent plan
    x = torch.zeros(1, 1, Mk * (T_ana - 1) + Ka)
    wa = torch.zeros(Mk, 1, Ka)
    ws = torch.zeros(Mk, Mk, Ks)
    T_out = 32 + T_ana - Ks + 1
    out = torch.full((1, T_out, Mk), float("nan"))
    err = emulated.pqmf_roundtrip_conv(
        x.data_ptr(), wa.data_ptr(), ws.data_ptr(), out.data_ptr(), 1,
        x.shape[-1], Mk, Ka, Ks, T_ana, T_out, 0, 16, None)
    assert err != 0
    assert torch.isnan(out).all()
    assert not cc.fused_roundtrip_supported(Mk, Ka, Ks) or \
        case == "no_cluster_fits"


def test_wrapper_raises_what_the_card_refuses(monkeypatch):
    """The wrappers raise on every launch the card refuses: the C entry's
    cudaError_t (a refused cluster launch, none of the whole-file clusters
    fitting) comes back through ``_launch`` as a RuntimeError that names
    it, and a geometry whose cluster tile leaves a block's shared memory is
    refused by the gate the wrapper asks before any launch, at every tier.
    No route falls back to K1 + K2 or to a plain version."""
    import types

    from pqmf_tpu_torch.kernels import _build

    class Lib:
        def pqmf_roundtrip_conv(self, *args):
            return 9  # cudaErrorInvalidConfiguration

        def pqmf_error_string(self, err):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    with pytest.raises(RuntimeError, match="pqmf_roundtrip_conv failed: "
                       "invalid configuration argument \\(9\\)"):
        cc._launch("pqmf_roundtrip_conv", 0, 0, 0, 0)
    for M in (32, 64):
        for tier in TIERS:
            assert cc.fused_roundtrip_supported(M, 32 * M + 1, 33, tier)
            # a bank whose slice, window and tile leave 227 KB
            assert not cc.fused_roundtrip_supported(M, 200 * M + 1, 33, tier)
        assert not cc._rtc_fits(M, 200 * M + 1, 33)
    # a cluster past the portable 8 blocks is never planned
    assert not cc._rtc_fits(128, 32 * 128 + 1, 33)


def test_rt_plan_header_matches_its_mirror(tmp_path):
    """``csrc/rt_plan.h``, the one C copy of the fused round trip's
    call-size tile choice (K3 at M >= 32 and K3t include it), built with
    g++ and held against ``cached_conv._rt_tile_choice`` over host blocks,
    stream batches and whole files on cards of 2 to 144 SMs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the header")
    csrc = Path(cc.__file__).parent.parent / "csrc"
    (tmp_path / "t.cpp").write_text(
        '#include "rt_plan.h"\n'
        'extern "C" int tile(int B, int T, int n, int c) '
        '{ return rt_call_tile(B, T, n, c); }\n')
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    f"-I{csrc}", "-o", str(tmp_path / "t.so"),
                    str(tmp_path / "t.cpp")], check=True, capture_output=True)
    tile = ctypes.CDLL(str(tmp_path / "t.so")).tile
    tile.argtypes = [ctypes.c_int] * 4
    for n_sms in (2, 66, 114, 132, 144):
        for B in (1, 2, 3, 16, 215):
            for T_out in (1, 15, 16, 17, 128, 256, 257, 512, 2048, 8192,
                          82704, 165375):
                for cluster in (1, 4, 8):
                    persist, Tt = cc._rt_tile_choice(B, T_out, n_sms,
                                                     cluster)
                    assert tile(B, T_out, n_sms, cluster) == (
                        0 if persist else Tt), (B, T_out, n_sms, cluster)
    # the tile choice counts a cluster's blocks: 16 streams at M = 32
    # take 64-step tiles either way, 3 streams at M = 64 (128 steps) take
    # 64 steps in clusters of 8 where one block a tile would take 16
    assert cc._rt_tile_choice(16, 256, 132, 4) == (False, 64)
    assert cc._rt_tile_choice(3, 128, 132, 1) == (False, 16)
    assert cc._rt_tile_choice(3, 128, 132, 8) == (False, 64)


def _kernel_ab():
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "tools" / "kernel_ab.py"
    spec = importlib.util.spec_from_file_location("kernel_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(_kernel_ab().VARIANTS))
def test_kernel_ab_variants_edit_the_sources(name):
    """Each edit of a ``tools/kernel_ab.py`` variant names text found
    exactly once in its file (the three sources and ``rt_plan.h``), so no
    A/B silently builds the sources as they are."""
    from pqmf_tpu_torch.kernels import _build

    files = {f.name: f for f in _build.SOURCES + _build.HEADERS}
    for which, old, new in _kernel_ab().VARIANTS[name]:
        assert files[which].read_text().count(old) == 1, (name, old)
        assert old != new
