// Hand-written Hopper (sm_90a) kernels for the PQMF streaming path's three
// convolutions.  Plain C interface, built with nvcc and loaded with ctypes
// (pqmf_tpu_torch/kernels/_build.py); the Python wrappers, their plain
// PyTorch versions and a mirror of every launch plan live in
// pqmf_tpu_torch/kernels/cached_conv.py.
//
// Every kernel computes a VALID convolution in f32, launches on the stream it
// is given and allocates nothing.  Each takes a zero pad of its input
// (pad_left, or K3's analysis pad pad_a, and zeros past the input) and
// applies it while it copies its window.
//
// K1 analysis   replaces pqmf_tpu/kernels/cached_conv.py:strided_analysis_conv
//   out[b,c,t] = sum_k w[c,0,k] * xpad[b,0,t*M+k]  (x -1 where c odd, t even)
// K2 synthesis  replaces pqmf_tpu/kernels/cached_conv.py:dense_synthesis_conv
//   out[b,t,c] = M * sum_{m,k} w[M-1-c,m,k] * s(m,t+k) * x[b,m,t+k]
// K3 roundtrip  replaces pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv
//   K2(pad(K1(pad(x, pad_a)), pad_left), w_syn) with both sign masks,
//   which cancel.
//
// What bounds them on the H100: all three are f32 FMA on the CUDA cores
// (the "highest" tier is full f32, so no tensor-core tier applies), at about
// 1 kFLOP per input sample for K1 and 1 kFLOP per output sample for K2 against
// 8 bytes of device memory each: arithmetic, not HBM.  An inner loop that
// loads one operand from shared memory per FMA is bound by those loads
// instead, so all three share one register tile (slide_fma): each thread
// keeps NB bands x NT steps of sums, loads NB weights of a tap as one vector
// and slides a window of the input along the taps, one float4 per 4 taps —
// 5 loads per 4*NB*NT FMAs.
//
// K1 and K3 read their input window in polyphase form, xp[r][tau] =
// x[M*tau + r], so the strided analysis is a dense M -> Mb conv of J =
// ceil(K/M) taps over the phases r: slide_fma over each phase, with the bank
// staged phase-major.  That is K2's shape with phases for input bands, so K1
// takes K2's launch plan: small calls split the phase sum over threads and
// reduce it in shared memory, large calls run as many blocks as fit on the
// card at once, each staging its bank chunk once and walking its tiles.  A
// second window buffer (the next tile's copy in flight) measured ~20%
// slower at 60 s on an NVIDIA H100 80GB HBM3 at 700 W: it costs two of the
// six blocks an SM holds (PERF.md).
//
// In K3 the sub-band tile stays in
// shared memory and feeds the synthesis, and only a Ks-1 step halo of it is
// recomputed per tile (tiles of 512 sub-band steps at M=16: 1.07x).  Up to
// M=16 its blocks are persistent, one an SM: each stages both banks once,
// walks time tiles, and copies the next tile's window with cp.async while
// the current one computes.  At M=32 and 64 the banks do not fit a block
// (266 KB and 1.07 MB in f32), so roundtrip_cluster_kernel runs a thread-
// block cluster of M/8 blocks a tile (Hopper's distributed shared memory):
// each block keeps 1/C of both banks, staged once a launch, computes 8
// sub-bands of the tile, and reads the other blocks' sub-band rows through
// distributed shared memory before it computes its 8 output channels (see
// the note above the kernel).  Its plan follows the call, as K3t's: whole
// files run persistent clusters over tiles of 256 sub-band steps, host
// blocks one cluster a tile of 16-64 output steps.  K2 chooses its tile
// from the call's size
// (launch_plan): large calls run persistent blocks of big tiles, small ones
// split the band sum across the threads of a block and reduce it in shared
// memory, so a block of 512 steps still spreads over the whole card.  K2
// copies its bank and window with cp.async too: a small call is bound by
// that staging, and the asynchronous copies skip the round trip through
// registers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "rt_plan.h"

namespace {

constexpr int kThreads = 256;   // threads per block of K3
constexpr int kWeightBytes = 64 * 1024;  // cap on the bank chunk K1/K2 stage
constexpr size_t kStaticSmem = 48 * 1024;
constexpr int kNT = 8;          // K3 (and large K1/K2 calls): steps a thread tile
constexpr int kSynThreads = 128;     // K1/K2: most threads a block
constexpr int kSynMaxSteps = 256;    // K1/K2: most output steps a block
constexpr int kSynFill = 128;        // K1/K2: threads an SM should get
constexpr int kAnaWindow = 4096;     // K1: input samples a tile's window holds
constexpr int kAnaGroups = 2;        // K1: most band groups of 4 a block
constexpr size_t kSmemPerSm = 233472;  // shared memory of one SM
constexpr size_t kSmemLimit = 232448;  // shared memory one block may use
// K1/K2 split the band (phase) sum only up to 16: a split sum of 1056+
// terms (M=32, 64) rounds far enough from the plain conv's order to leave
// K12_TOL
constexpr int kSplitMaxBands = 16;
// K3 at M >= 32 (roundtrip_cluster_kernel): a cluster of M / kRtcBlockBands
// blocks a tile, each with kRtcBlockBands of the analysis bands and of the
// output channels; most threads a block; the sub-band steps of a whole-file
// tile; the thread tiles (bands x steps) of whole files and of host blocks.
// The call-size tile choice is K3t's (rt_plan.h)
constexpr int kRtcMinBands = 32;
constexpr int kRtcBlockBands = 8;
constexpr int kRtcThreads = 256;
constexpr int kRtcSub = 256;
constexpr int kRtcNB = 2;
constexpr int kRtcNT = 8;
constexpr int kRtcSmallNB = 1;
constexpr int kRtcSmallNT = 4;
constexpr int kRtcMaxCluster = 8;  // the portable cluster size

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

inline int min_i(int a, int b) { return a < b ? a : b; }
inline int max_i(int a, int b) { return a > b ? a : b; }

// A launch: grid, threads, the output steps of one tile, the steps of one
// thread tile (K1/K2's NT; K3's sub-band steps a tile), the split of K1's
// phase sum / K2's band sum, and the dynamic shared memory.
// cached_conv.launch_plan mirrors it.
struct Plan {
  int gx, gy, gz, threads, tile_steps, aux, split;
  size_t smem;
};

// The choice K1 and K2 share, for a call of n_groups groups of 4 output
// channels whose sum runs over split_sum inputs (K1's phases, K2's bands):
// thread tiles of 4 channels x NT steps.  Split the sum (MS threads a tile,
// at most 16, for at most kSplitMaxBands inputs) until the card holds
// kSynFill threads an SM, then halve NT; with a split, grow the blocks (SG
// thread tiles, at most kSynThreads threads and max_steps steps) while
// there are still as many blocks as SMs.  Without one SG is the caller's.
struct Split {
  int NT, MS, SG;
};

Split split_choice(int B, int n_groups, int split_sum, int T_out,
                   int max_steps, int n_sms) {
  const long long fill = (long long)n_sms * kSynFill;
  Split c = {kNT, 1, 1};
  const long long items = (long long)B * cdiv(T_out, c.NT) * n_groups;
  while (c.MS < 16 && 2 * c.MS <= split_sum && split_sum <= kSplitMaxBands &&
         items * c.MS < fill)
    c.MS *= 2;
  if (items * c.MS < fill) c.NT = 4;
  if (c.MS > 1)
    while (2 * c.SG * c.MS <= kSynThreads && 2 * c.SG * c.NT <= max_steps &&
           (long long)B * cdiv(T_out, 2 * c.SG * c.NT) * n_groups >= n_sms)
      c.SG *= 2;
  return c;
}

// K1: band groups of 4 a block (at most 2: 8 bands), at most kWeightBytes
// of bank (M*J taps a band).
inline int analysis_band_groups(int M, int Mb, int J) {
  return max_i(1, min_i(min_i(cdiv(Mb, 4), kAnaGroups),
                         kWeightBytes / (16 * M * J)));
}

// K1: the most output steps a tile, so that a window holds ~kAnaWindow samples
inline int analysis_max_steps(int M) {
  return max_i(kNT, min_i(kSynMaxSteps, kAnaWindow / M));
}

size_t analysis_plan_smem(int M, int J, int CB, int Tt, int red) {
  return sizeof(float) *
         ((size_t)M * J * CB + (size_t)M * round4(Tt + J + 4) + red);
}

// K1's plan: split_choice over its M phases for each group of 4 bands.  A
// call that needs no split takes tiles of up to 8 bands and runs as many
// blocks as fit on the card at once, each walking its tiles.
Plan analysis_plan(int B, int M, int Mb, int K, int T_out, int n_sms) {
  const int J = cdiv(K, M);
  const int n_bg = cdiv(Mb, 4);
  const int max_steps = analysis_max_steps(M);
  const Split c = split_choice(B, n_bg, M, T_out, max_steps, n_sms);
  const int NT = c.NT, MS = c.MS;
  int SG = c.SG, PG = 1;
  if (MS == 1) {
    PG = analysis_band_groups(M, Mb, J);
    SG = max_i(1, min_i(max_steps / NT, kSynThreads / PG));
  }
  Plan p;
  p.threads = SG * PG * MS;
  p.tile_steps = NT * SG;
  p.aux = NT;
  p.split = MS;
  p.smem = analysis_plan_smem(M, J, 4 * PG, p.tile_steps,
                              MS > 1 ? p.threads * NT * 4 : 0);
  const int tiles = B * cdiv(T_out, p.tile_steps);
  p.gy = cdiv(n_bg, PG);
  const int per_sm = max_i(1, min_i(2048 / p.threads,
                                    (int)(kSmemPerSm / (p.smem + 1024))));
  p.gx = MS == 1 ? min_i(tiles, max_i(1, n_sms * per_sm / p.gy)) : tiles;
  p.gz = 1;
  return p;
}

// The most shared memory any K1 plan of this bank takes (the gate).
size_t analysis_smem(int M, int Mb, int K) {
  const int J = cdiv(K, M);
  return analysis_plan_smem(M, J, 4 * analysis_band_groups(M, Mb, J),
                            analysis_max_steps(M), kSynThreads * kNT * 4);
}

// K2: phase groups of 4 a block (at most 2: 8 phases), at most
// kWeightBytes of bank.
inline int synthesis_phase_groups(int M, int Mb, int K) {
  return max_i(1, min_i(min_i(cdiv(M, 4), 2), kWeightBytes / (16 * Mb * K)));
}

size_t synthesis_plan_smem(int Mb, int K, int CG, int Tt, int red) {
  return sizeof(float) * ((size_t)Mb * K * CG + (size_t)Mb * round4(Tt + K + 4)
                          + red);
}

// K2's plan: split_choice over its Mb input bands for each group of 4
// phases.
Plan synthesis_plan(int B, int M, int Mb, int K, int T_out, int n_sms) {
  const int n_pg = cdiv(M, 4);
  const Split c = split_choice(B, n_pg, Mb, T_out, kSynMaxSteps, n_sms);
  const int NT = c.NT, MS = c.MS;
  int SG = c.SG, PG = 1;
  if (MS == 1) {  // a large call: blocks of 4*PG phases
    PG = synthesis_phase_groups(M, Mb, K);
    SG = max_i(1, min_i(kSynMaxSteps / NT, kSynThreads / PG));
  }
  Plan p;
  p.threads = SG * PG * MS;
  p.tile_steps = NT * SG;
  p.aux = NT;
  p.split = MS;
  p.smem = synthesis_plan_smem(Mb, K, 4 * PG, NT * SG,
                               MS > 1 ? MS * SG * PG * NT * 4 : 0);
  // one tile a block, or for a large call as many blocks as fit on the
  // card at once, each walking several tiles with its bank staged once
  const int tiles = B * cdiv(T_out, p.tile_steps);
  const int per_sm = max_i(1, min_i(2048 / p.threads,
                                    (int)(kSmemPerSm / (p.smem + 1024))));
  p.gx = MS == 1 ? min_i(tiles, n_sms * per_sm) : tiles;
  p.gy = cdiv(n_pg, PG);
  p.gz = 1;
  return p;
}

// The most shared memory any K2 plan of this bank takes (the gate).
size_t synthesis_smem(int M, int Mb, int K) {
  return synthesis_plan_smem(Mb, K, 4 * synthesis_phase_groups(M, Mb, K),
                             kSynMaxSteps, kSynThreads * kNT * 4);
}

// K3's geometry: NB bands a thread tile, BG = M/NB band groups, and a tile
// of n_sub sub-band steps (one analysis thread tile per thread) of which
// Tt are output steps; J taps per phase of the analysis bank.
struct RtGeom {
  int NB, BG, n_sub, Tt, J, XR, SP;
  size_t smem;
};

RtGeom roundtrip_geom(int M, int Ka, int Ks) {
  RtGeom g;
  g.NB = M < 4 ? M : 4;
  g.BG = max_i(1, M / g.NB);
  g.n_sub = kThreads * kNT / g.BG;
  g.Tt = max_i(0, (g.n_sub - Ks + 1) / kNT * kNT);
  g.J = cdiv(Ka, M);
  g.XR = round4(g.n_sub + g.J + 4);  // one phase of the window
  g.SP = g.n_sub + 8;                // one band of the sub-band tile
  g.smem = sizeof(float) * ((size_t)M * g.J * M + (size_t)M * Ks * M +
                            (size_t)M * g.SP + 2 * (size_t)M * g.XR);
  return g;
}

bool roundtrip_templated(int M) {
  return M == 2 || M == 4 || M == 8 || M == 16 || M == 32 || M == 64;
}

// A tile of roundtrip_cluster_kernel (M >= 32), for each of the C = M/8
// blocks of its cluster: thread tiles of NB bands x NT steps (2 x 8 on
// whole files; 1 x 4 on host blocks, where a block's few threads and the
// 2112-term sums make latency, not issue, the limit), one per thread in
// each phase, in whole warps; Tt output steps of n_sub sub-band steps; the
// block's analysis bank [M phases][PS] (J*8 taps x bands, padded so that
// PS = 8 mod 32: the staging copies meet no bank twice), its synthesis
// bank [M][Ks][8], its own sub-band rows [8][SP] and the window [M][XR],
// which the whole sub-band tile [M][SP] takes over once the analysis has
// read it.  Tt = 0: a whole file's tile.
struct RtcTile {
  int C, NB, NT, n_sub, Tt, threads, J, XR, SP, PS;
  size_t smem;
};

RtcTile rtc_tile(int M, int Ka, int Ks, int Tt) {
  constexpr int MB = kRtcBlockBands;
  RtcTile t;
  t.C = M / MB;
  t.J = cdiv(Ka, M);
  if (Tt == 0) {
    t.NB = kRtcNB;
    t.NT = kRtcNT;
    t.n_sub = kRtcSub;
    t.Tt = max_i(0, (t.n_sub - Ks + 1) / t.NT * t.NT);
  } else {
    t.NB = kRtcSmallNB;
    t.NT = kRtcSmallNT;
    t.Tt = Tt;
    t.n_sub = cdiv(Tt + Ks - 1, t.NT) * t.NT;
  }
  t.threads = (MB / t.NB * (t.n_sub / t.NT) + 31) & ~31;  // whole warps
  t.XR = round4(t.n_sub + t.J + 4);
  t.SP = t.n_sub + 8;
  t.PS = t.J * MB + ((MB - t.J * MB) & 31);
  t.smem = sizeof(float) * ((size_t)M * t.PS + (size_t)M * Ks * MB +
                            (size_t)MB * t.SP + (size_t)M * t.XR);
  return t;
}

// the tiles a plan can take: whole files (0), small calls'
constexpr int kRtcTiles[4] = {0, kRtSmall[0], kRtSmall[1], kRtSmall[2]};

// the most shared memory any of its plans takes (the gate)
size_t rtc_smem(int M, int Ka, int Ks) {
  size_t m = 0;
  for (int Tt : kRtcTiles) {
    const size_t s = rtc_tile(M, Ka, Ks, Tt).smem;
    m = s > m ? s : m;
  }
  return m;
}

// whether every tile a plan can take launches: whole clusters of at most
// the portable size, output steps, threads, shared memory
bool rtc_fits(int M, int Ka, int Ks) {
  if (M % kRtcBlockBands || M / kRtcBlockBands > kRtcMaxCluster ||
      rtc_tile(M, Ka, Ks, 0).Tt <= 0)
    return false;
  for (int Tt : kRtcTiles)
    if (rtc_tile(M, Ka, Ks, Tt).threads > kRtcThreads) return false;
  return rtc_smem(M, Ka, Ks) <= kSmemLimit;
}

// The tile of a call of B rows of T_out output steps (rt_plan.h, counting
// the cluster's blocks): whole files the whole-file tile in persistent
// clusters, smaller calls one tile of 16-64 steps a cluster.
RtcTile rtc_choice(int B, int M, int Ka, int Ks, int T_out, int n_sms,
                   bool* persist) {
  const int Tt = rt_call_tile(B, T_out, n_sms, M / kRtcBlockBands);
  *persist = Tt == 0;
  return rtc_tile(M, Ka, Ks, Tt);
}

// max_clusters: the clusters of the whole-file tile the card holds at once
// (cudaOccupancyMaxActiveClusters; a cluster lives inside one GPC)
Plan roundtrip_plan(int B, int M, int Ka, int Ks, int T_out, int n_sms,
                    int max_clusters) {
  Plan p;
  if (M >= kRtcMinBands) {
    bool persist = false;
    const RtcTile t = rtc_choice(B, M, Ka, Ks, T_out, n_sms, &persist);
    const int n_tiles = t.Tt > 0 ? B * cdiv(T_out, t.Tt) : 0;
    p.gx = (persist ? min_i(n_tiles, max_i(0, max_clusters)) : n_tiles) * t.C;
    p.gy = 1;
    p.gz = 1;
    p.threads = t.threads;
    p.tile_steps = t.Tt;
    p.aux = t.n_sub;
    p.split = t.C;
    p.smem = t.smem;
    return p;
  }
  const RtGeom g = roundtrip_geom(M, Ka, Ks);
  const int n_tiles = g.Tt > 0 ? B * cdiv(T_out, g.Tt) : 0;
  p.gx = min_i(n_tiles, n_sms);
  p.gy = 1;
  p.gz = 1;
  p.threads = kThreads;
  p.tile_steps = g.Tt;
  p.aux = g.n_sub;
  p.split = 1;
  p.smem = g.smem;
  return p;
}

// ---------------------------------------------------------------------------
// The register tile K1, K2 and K3 share.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N consecutive floats, one vector load (p aligned to N floats).
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = ld4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 1) {
    v[0] = *p;
  } else {
    static_assert(N == 2, "vectors of 1, 2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 1) {
    *p = v[0];
  } else {
    static_assert(N == 2, "vectors of 1, 2 or 4 floats");
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// acc[b][i] += sum_{q < nq} w[q*ws + b] * x[i + q] for b < NB, i < NT: an
// NB x NT outer-product tile that slides a register window of x along the
// taps.  Per 4 taps: one float4 of x and 4 NB-wide weight loads for
// 4*NB*NT FMAs.  w is aligned to NB floats and ws a multiple of NB; x is
// 16-byte aligned, and x[0 .. nq + NT + 3] lies in the caller's buffer.
template <int NB, int NT>
__device__ __forceinline__ void slide_fma(float (&acc)[NB][NT],
                                          const float* __restrict__ w, int ws,
                                          const float* __restrict__ x,
                                          int nq) {
  float win[NT + 4];
#pragma unroll
  for (int i = 0; i < NT; i += 4) {
    const float4 t = ld4(x + i);
    win[i] = t.x; win[i + 1] = t.y; win[i + 2] = t.z; win[i + 3] = t.w;
  }
  int q = 0;
#pragma unroll 8
  for (; q + 4 <= nq; q += 4) {
    const float4 t = ld4(x + q + NT);
    win[NT] = t.x; win[NT + 1] = t.y; win[NT + 2] = t.z; win[NT + 3] = t.w;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float wv[NB];
      ld_vec<NB>(w + (q + d) * ws, wv);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < NT; ++i)
          acc[b][i] = fmaf(wv[b], win[i + d], acc[b][i]);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) win[i] = win[i + 4];
  }
  const int rem = nq - q;  // 0..3 taps left
  if (rem > 0) {
    const float4 t = ld4(x + q + NT);
    win[NT] = t.x; win[NT + 1] = t.y; win[NT + 2] = t.z; win[NT + 3] = t.w;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d < rem) {
        float wv[NB];
        ld_vec<NB>(w + (q + d) * ws, wv);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int i = 0; i < NT; ++i)
            acc[b][i] = fmaf(wv[b], win[i + d], acc[b][i]);
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
// 16 bytes, of which the first `bytes` are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (release: its shared-memory writes become visible to the
// cluster), and waits (acquire) until all have; a thread's arrivals and
// waits alternate.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// p (this block's shared memory) at the same offset in the shared memory of
// the cluster's block `rank` (distributed shared memory, a generic address)
__device__ __forceinline__ const float* cluster_ptr(const float* p,
                                                    int rank) {
  unsigned long long r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

// q = e / M and r = e % M, by a shift and a mask where M = 2^lg (lg >= 0):
// K1's staging splits every copied index so, and a division costs ~20 ops
__device__ __forceinline__ void div_mod(int e, int M, int lg, int& q,
                                        int& r) {
  if (lg >= 0) {
    q = e >> lg;
    r = e & (M - 1);
  } else {
    q = e / M;
    r = e - q * M;
  }
}

// ---------------------------------------------------------------------------
// K1: strided analysis over the polyphase window.  Block (tiles, band
// chunk): it stages its chunk of the bank once and walks the tiles (batch
// row, time tile) with a stride of the grid; thread (tile u = (step group,
// band group), phase split ms).
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kSynThreads)
analysis_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int B, int Tx, int M, int Mb, int K,
                int T_out, int pad_left, int SG, int PG, int MS,
                int fuse_mask, int lgM) {
  extern __shared__ float4 ana_smem[];
  float* smem = reinterpret_cast<float*>(ana_smem);
  const int CB = 4 * PG;
  const int U = SG * PG;
  const int Tt = NT * SG;
  const int J = cdiv(K, M);
  const int XR = round4(Tt + J + 4);     // one phase of the window
  float* w_s = smem;                     // [M][J][CB] = w[c0+c][j*M + r]
  float* xp_s = w_s + M * J * CB;        // [M][XR] = xpad[M*(t0+tau) + r]
  float* red_s = xp_s + M * XR;          // [MS][CB][Tt] partial sums
  const int c0 = blockIdx.y * CB;
  const int tid = threadIdx.x;
  const int tiles_x = cdiv(T_out, Tt);
  const int n_tiles = B * tiles_x;
  const int u = tid % U;
  const int ms = tid / U;
  const int pg = u % PG;
  const int sg = u / PG;

  // the bank chunk, phase-major: w_s[(r*J + j)*CB + c] = w[c0+c][j*M + r],
  // zero past the last band (those sums are not stored); taps past K are
  // never multiplied and not written
  for (int c = 0; c < CB; ++c) {
    const bool band = c0 + c < Mb;
    const float* src = w + (long long)(band ? c0 + c : 0) * K;
    for (int k = tid; k < K; k += blockDim.x) {
      int j, r;
      div_mod(k, M, lgM, j, r);
      cp_async4(w_s + (r * J + j) * CB + c, band ? src + k : w,
                band ? 4 : 0);
    }
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_x;
    const int t0 = (tile % tiles_x) * Tt;
    if (tile != blockIdx.x) __syncthreads();  // the last tile is done
    // the window in polyphase form; the zero pad (pad_left, and past the
    // input) is the copies' zero-fill.  Steps past Tt + J - 2 of a phase
    // row are read into slide_fma's registers but never multiplied, so
    // they are not copied
    const long long p0 = (long long)t0 * M - pad_left;
    const float* xb = x + (long long)b * Tx;
    for (int e = tid; e < M * (Tt + J - 1); e += blockDim.x) {
      const long long p = p0 + e;
      const bool in = p >= 0 && p < Tx;
      int tau, r;
      div_mod(e, M, lgM, tau, r);
      cp_async4(xp_s + r * XR + tau, in ? xb + p : xb, in ? 4 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float acc[4][NT];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[c][i] = 0.0f;
    for (int r = ms; r < M; r += MS)
      slide_fma<4, NT>(acc, w_s + r * J * CB + pg * 4, CB,
                       xp_s + r * XR + sg * NT, (K - r + M - 1) / M);

    if (MS == 1) {
      // reverse_half on the output: -1 where the band is odd and the global
      // step t even (t0 and ts are even, so t is even where i is)
      const int ts = t0 + sg * NT;
      const bool vec = (T_out & 3) == 0 && ts + NT <= T_out;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = c0 + pg * 4 + cc;
        if (c < Mb) {
          const float s = fuse_mask && (c & 1) ? -1.0f : 1.0f;
          float* o = out + ((long long)b * Mb + c) * T_out + ts;
          if (vec) {
#pragma unroll
            for (int i = 0; i < NT; i += 4)
              *reinterpret_cast<float4*>(o + i) =
                  make_float4(s * acc[cc][i], acc[cc][i + 1],
                              s * acc[cc][i + 2], acc[cc][i + 3]);
          } else {
#pragma unroll
            for (int i = 0; i < NT; ++i)
              if (ts + i < T_out) o[i] = (i & 1) ? acc[cc][i] : s * acc[cc][i];
          }
        }
      }
      continue;
    }
    float* rp = red_s + (ms * CB + pg * 4) * Tt + sg * NT;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int i = 0; i < NT; i += 4)
        *reinterpret_cast<float4*>(rp + cc * Tt + i) = make_float4(
            acc[cc][i], acc[cc][i + 1], acc[cc][i + 2], acc[cc][i + 3]);
    __syncthreads();
    const int n_out = CB * Tt;
    for (int o = tid; o < n_out; o += blockDim.x) {
      float sum = 0.0f;
      for (int j = 0; j < MS; ++j) sum += red_s[j * n_out + o];
      const int c = c0 + o / Tt;
      const int t = t0 + o % Tt;
      if (t < T_out && c < Mb)
        out[((long long)b * Mb + c) * T_out + t] =
            fuse_mask && (c & 1) && !(t & 1) ? -sum : sum;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dense synthesis, time-major output.  Block (tiles, phase chunk):
// it stages its chunk of the bank once and walks the tiles (batch row, time
// tile) with a stride of the grid; thread (tile u = (step group, phase
// group), band split ms).
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kSynThreads)
synthesis_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int B, int Mb, int Tx, int M,
                 int K, int T_out, int pad_left, int SG, int PG, int MS,
                 int fuse_mask, int x_offset) {
  extern __shared__ float4 syn_smem[];
  float* smem = reinterpret_cast<float*>(syn_smem);
  const int CG = 4 * PG;
  const int U = SG * PG;
  const int Tt = NT * SG;
  const int XW = round4(Tt + K + 4);  // one band of the window
  float* w_s = smem;                  // [Mb][K][CG] = w[M-1-c][m][k]
  float* x_s = w_s + Mb * K * CG;     // [Mb][XW], input sign applied
  float* red_s = x_s + Mb * XW;       // [MS][U][NT][4] partial sums
  const int c0 = blockIdx.y * CG;
  const int tid = threadIdx.x;
  const int tiles_x = cdiv(T_out, Tt);
  const int u = tid % U;
  const int ms = tid / U;
  const int pg = u % PG;
  const int sg = u / PG;

  // the bank chunk, transposed to [m][k][c] by asynchronous copies (the
  // gain M is applied to the sums: a power of two, so the same floats)
  const int MK = Mb * K;
  for (int c = 0; c < CG; ++c) {
    const bool in = c0 + c < M;
    const float* src = w + (long long)(in ? M - 1 - c0 - c : 0) * MK;
#pragma unroll 4
    for (int f = tid; f < MK; f += blockDim.x)
      cp_async4(w_s + f * CG + c, src + f, in ? 4 : 0);
  }
  const float gain = (float)M;
  // 16-byte copies where whole groups of 4 steps lie inside or outside the
  // input (the pad a multiple of 4)
  const bool rows16 = (Tx & 3) == 0 && (pad_left & 3) == 0 && aligned16(x);
  const int XW4 = XW >> 2;
  const int xo = x_offset - pad_left;  // the position of window step 0
  for (int tile = blockIdx.x; tile < B * tiles_x; tile += gridDim.x) {
    const int b = tile / tiles_x;
    const int t0 = (tile % tiles_x) * Tt;
    if (tile != blockIdx.x) __syncthreads();  // the last tile is done
    // the window, 4 steps a copy (16 bytes where rows are aligned), the
    // zero pad (pad_left, and past the input) as the copies' zero-fill;
    // then reverse_half on the input, by the sample's position in the
    // unpadded signal (& 1 keeps the parity right where it is negative),
    // each thread on the steps it copied
    const float* xb = x + (long long)b * Mb * Tx;
#pragma unroll 4
    for (int e = tid; e < Mb * XW4; e += blockDim.x) {
      const int m = e / XW4;
      const int tau = t0 + 4 * (e - m * XW4);
      const int s = tau - pad_left;  // the input step of window step tau
      const float* src = xb + (long long)m * Tx + s;
      if (rows16) {
        const int n = s < 0 ? 0 : min(max(Tx - s, 0), 4);
        cp_async16(x_s + 4 * e, n ? src : xb, 4 * n);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = s + j >= 0 && s + j < Tx;
          cp_async4(x_s + 4 * e + j, in ? src + j : xb, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (fuse_mask) {
      for (int e = tid; e < Mb * XW4; e += blockDim.x) {
        const int m = e / XW4;
        if (m & 1) {
          const int tau = t0 + 4 * (e - m * XW4);
          float* v = x_s + 4 * e + ((tau + xo) & 1 ? 1 : 0);
          v[0] = -v[0];  // the first and third even steps of the four
          v[2] = -v[2];
        }
      }
    }
    __syncthreads();

    float acc[4][NT];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[c][i] = 0.0f;
    for (int m = ms; m < Mb; m += MS)
      slide_fma<4, NT>(acc, w_s + m * K * CG + pg * 4, CG,
                       x_s + m * XW + sg * NT, K);

    if (MS == 1) {
      const int c = c0 + pg * 4;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int t = t0 + sg * NT + i;
        if (t >= T_out) break;
        float* o = out + ((long long)b * T_out + t) * M + c;
        if ((M & 3) == 0 && c + 4 <= M) {
          *reinterpret_cast<float4*>(o) =
              make_float4(gain * acc[0][i], gain * acc[1][i],
                          gain * acc[2][i], gain * acc[3][i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < M) o[j] = gain * acc[j][i];
        }
      }
      continue;
    }
    float* r = red_s + (ms * U + u) * NT * 4;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<float4*>(r + 4 * i) =
          make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
    __syncthreads();
    const int n_out = U * NT * 4;
    for (int o = tid; o < n_out; o += blockDim.x) {
      float sum = 0.0f;
      for (int j = 0; j < MS; ++j) sum += red_s[j * n_out + o];
      const int i = (o >> 2) % NT;
      const int uu = (o >> 2) / NT;
      const int t = t0 + (uu / PG) * NT + i;
      const int c = c0 + (uu % PG) * 4 + (o & 3);
      if (t < T_out && c < M)
        out[((long long)b * T_out + t) * M + c] = gain * sum;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: fused round trip.  Persistent blocks, one an SM, walk the tiles
// (batch row, output time tile) with a stride of the grid.
// ---------------------------------------------------------------------------
template <int M>
__global__ void __launch_bounds__(kThreads, 1)
roundtrip_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                 const float* __restrict__ ws, float* __restrict__ out,
                 int B, int Tx, int Ka, int Ks, int T_ana, int T_out,
                 int pad_a, int pad_left, int n_sub, int Tt, int J, int XR,
                 int SP) {
  constexpr int NB = M < 4 ? M : 4;
  constexpr int BG = M / NB;
  extern __shared__ float4 rt_smem[];
  float* wa_s = reinterpret_cast<float*>(rt_smem);  // [r][J][M]
  float* ws_s = wa_s + M * J * M;     // [m][Ks][M] = M * ws[M-1-c][m][k]
  float* sub_s = ws_s + M * Ks * M;   // [M][SP] sub-band tile + halo
  float* xp_s = sub_s + M * SP;       // [2][M][XR] = x[M*(tau0+tau) + r]
  const int tid = threadIdx.x;
  const int tiles_per_row = cdiv(T_out, Tt);
  const int n_tiles = B * tiles_per_row;

  // the window of tile `tl` into buffer `buf`, zeros outside the input
  // (the analysis pad pad_a, and past its end)
  auto load_window = [&](int tl, int buf) {
    const int row = tl / tiles_per_row;
    const long long p0 =
        (long long)((tl % tiles_per_row) * Tt - pad_left) * M - pad_a;
    const float* xb = x + (long long)row * Tx;
    float* dst = xp_s + buf * M * XR;
    for (int e = tid; e < M * XR; e += kThreads) {
      const long long p = p0 + e;
      const bool in = p >= 0 && p < Tx;
      cp_async4(dst + (e % M) * XR + e / M, in ? xb + p : xb, in ? 4 : 0);
    }
  };

  int tile = blockIdx.x;
  load_window(tile, 0);
  cp_async_commit();
  // wa_s[(r*J + j)*M + m] = wa[m][j*M + r], zero past Ka
  for (int e = tid; e < M * Ka; e += kThreads) {
    const int m = e / Ka;
    const int k = e - m * Ka;
    wa_s[((k % M) * J + k / M) * M + m] = wa[e];
  }
  for (int e = tid; e < M * J * M; e += kThreads) {  // taps past Ka
    const int rj = e / M;
    if ((rj % J) * M + rj / J >= Ka) wa_s[e] = 0.0f;
  }
  // ws_s[(m*Ks + k)*M + c] = M * ws[M-1-c][m][k]: lanes read consecutive
  // taps of one phase (coalesced)
  for (int e = tid; e < M * M * Ks; e += kThreads) {
    const int c = e / (M * Ks);
    ws_s[(e - c * M * Ks) * M + M - 1 - c] = (float)M * ws[e];
  }
  for (int e = tid; e < M * (SP - n_sub); e += kThreads) {
    const int m = e / (SP - n_sub);
    sub_s[m * SP + n_sub + e % (SP - n_sub)] = 0.0f;
  }

  for (int it = 0; tile < n_tiles; ++it) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      load_window(next, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int row = tile / tiles_per_row;
    const int t0 = (tile % tiles_per_row) * Tt;
    const int tau0 = t0 - pad_left;  // sub-band time of sub_s[.][0]
    const int n_out = min(Tt, T_out - t0);
    const float* xp = xp_s + (it & 1) * M * XR;

    // analysis of the tile and its halo; the synthesis pad and the sub-band
    // signal's end are zeros, as in the composition
    if (tid < BG * (n_sub / kNT)) {
      const int bg = tid % BG;
      const int s0 = tid / BG * kNT;
      if (s0 < n_out + Ks - 1) {
        float acc[NB][kNT];
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int i = 0; i < kNT; ++i) acc[c][i] = 0.0f;
        for (int r = 0; r < M; ++r)
          slide_fma<NB, kNT>(acc, wa_s + r * J * M + bg * NB, M,
                             xp + r * XR + s0, (Ka - r + M - 1) / M);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          float* dst = sub_s + (bg * NB + c) * SP + s0;
#pragma unroll
          for (int i = 0; i < kNT; i += 4) {
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int tau = tau0 + s0 + i + j;
              v[j] = (tau >= 0 && tau < T_ana) ? acc[c][i + j] : 0.0f;
            }
            st_vec<4>(dst + i, v);
          }
        }
      }
    }
    __syncthreads();

    if (tid < BG * (Tt / kNT)) {
      const int cg = tid % BG;
      const int tl = tid / BG * kNT;
      if (tl < n_out) {
        float acc[NB][kNT];
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int i = 0; i < kNT; ++i) acc[c][i] = 0.0f;
        for (int m = 0; m < M; ++m)
          slide_fma<NB, kNT>(acc, ws_s + m * Ks * M + cg * NB, M,
                             sub_s + m * SP + tl, Ks);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (tl + i < n_out) {
            float v[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c) v[c] = acc[c][i];
            st_vec<NB>(out + ((long long)row * T_out + t0 + tl + i) * M +
                           cg * NB, v);
          }
        }
      }
    }
    tile = next;
  }
}

// ---------------------------------------------------------------------------
// K3 at M = 32, 64: roundtrip_cluster_kernel replaces pqmf_tpu/kernels/
// cached_conv.py:fused_roundtrip_conv (:794; _fused_roundtrip_single :715,
// its pallas_call :751) at these band counts.  It is bound by f32 FMAs on
// the CUDA cores (~2.1 kFMA a sub-band step and ~2.1 a sample out at M = 64:
// 11 GFMA on 60 s against 21 MB of device memory), so its design keeps every
// FMA's operands in shared memory and registers: one thread-block cluster of
// C = M/8 blocks a tile, block rank rho owning analysis bands and output
// channels [8 rho, 8 rho + 8).  Each block
// - stages its slice of both f32 banks once a launch, transposed by 4-byte
//   cp.async (135 KB at M = 64: a whole bank never fits a block); the
//   clusters are persistent on whole files, so the slices stay resident
//   across the tiles and no bank is read twice;
// - copies the tile's window (all M phases) itself and computes its 8
//   sub-bands of every step of the tile into its own rows;
// - meets the cluster in a barrier, reads every block's rows through
//   distributed shared memory into one local sub-band tile (over the window,
//   which the analysis has read), and arrives at a second barrier, whose
//   wait comes before it writes its own rows again or exits: a peer may
//   still be reading them;
// - computes its 8 output channels of the tile's output steps.
// Each output's sum runs in one thread, in K1's and K2's order (phase by
// phase, band by band): the split is over bands, never over taps.
// ---------------------------------------------------------------------------
template <int M, int NB, int NT>
__global__ void __launch_bounds__(kRtcThreads, 1)
roundtrip_cluster_kernel(const float* __restrict__ x,
                         const float* __restrict__ wa,
                         const float* __restrict__ ws,
                         float* __restrict__ out, int B, int Tx, int Ka,
                         int Ks, int T_ana, int T_out, int pad_a,
                         int pad_left, int n_sub, int Tt, int J, int XR,
                         int SP, int PS) {
  constexpr int MB = kRtcBlockBands;  // bands and channels a block
  constexpr int C = M / MB;           // blocks a cluster
  constexpr int BG = MB / NB;         // band groups of a block
  constexpr int lgM = M == 32 ? 5 : 6;
  static_assert(M == 32 || M == 64, "M = 32 or 64");
  extern __shared__ float4 rtc_shared[];
  // the analysis bank [M][PS], wa_s[r*PS + j*MB + c] = wa[c0+c][j*M + r];
  // the synthesis bank [M][Ks][MB] = ws[M-1-(c0+c)][m][k] (the gain M goes
  // on the sums: a power of two, the same floats); this block's sub-band
  // rows [MB][SP]; the window [M][XR] = x[M*(tau0+tau) + r], then the
  // whole sub-band tile [M][SP]
  float* wa_s = reinterpret_cast<float*>(rtc_shared);
  float* ws_s = wa_s + M * PS;
  float* own_s = ws_s + M * Ks * MB;
  float* xp_s = own_s + MB * SP;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rank = blockIdx.x % C;
  const int c0 = rank * MB;
  const int n_clusters = gridDim.x / C;
  const int tiles_per_row = cdiv(T_out, Tt);
  const int n_tiles = B * tiles_per_row;
  const int bg = tid % BG;
  const int s0 = tid / BG * NT;

  // the bank slices: lanes take 8 bands x 4 consecutive taps, which the row
  // strides (PS = 8 mod 32 phases; 8 floats a tap) put on 32 distinct banks
  for (int e = tid; e < MB * Ka; e += nthr) {
    const int c = e & (MB - 1);
    const int k = e >> 3;  // taps past Ka are never read and not copied
    cp_async4(wa_s + (k & (M - 1)) * PS + (k >> lgM) * MB + c,
              wa + (long long)(c0 + c) * Ka + k, 4);
  }
  const int MK = M * Ks;
  for (int e = tid; e < MB * MK; e += nthr) {
    const int c = e & (MB - 1);
    const int f = e >> 3;
    cp_async4(ws_s + f * MB + c, ws + (long long)(M - 1 - c0 - c) * MK + f,
              4);
  }
  for (int e = tid; e < MB * (SP - n_sub); e += nthr) {
    const int m = e / (SP - n_sub);
    own_s[m * SP + n_sub + e % (SP - n_sub)] = 0.0f;
  }
  // the window of tile `tl`, zeros outside the input (the analysis pad
  // pad_a, and past its end)
  auto load_window = [&](int tl) {
    const int row = tl / tiles_per_row;
    const long long p0 =
        (long long)((tl % tiles_per_row) * Tt - pad_left) * M - pad_a;
    const float* xb = x + (long long)row * Tx;
    for (int e = tid; e < M * XR; e += nthr) {
      const long long p = p0 + e;
      const bool in = p >= 0 && p < Tx;
      cp_async4(xp_s + (e & (M - 1)) * XR + (e >> lgM), in ? xb + p : xb,
                in ? 4 : 0);
    }
  };

  int tile = blockIdx.x / C;  // the cluster's tiles, all its blocks alike
  if (tile < n_tiles) load_window(tile);
  cp_async_commit();
  const float gain = (float)M;
  const int SP4 = SP >> 2;
  bool first = true;
  for (; tile < n_tiles; tile += n_clusters) {
    const int row = tile / tiles_per_row;
    const int t0 = (tile % tiles_per_row) * Tt;
    const int tau0 = t0 - pad_left;  // sub-band time of row step 0
    const int n_out = min(Tt, T_out - t0);
    cp_async_wait<0>();
    __syncthreads();  // the window (and the bank slices) are in

    // analysis of this block's bands over the tile and its halo (the rows
    // the synthesis reads)
    const bool ana = tid < BG * (n_sub / NT) && s0 < n_out + Ks - 1;
    float acc[NB][NT];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[c][i] = 0.0f;
    if (ana)
      for (int r = 0; r < M; ++r)
        slide_fma<NB, NT>(acc, wa_s + r * PS + bg * NB, MB,
                          xp_s + r * XR + s0, (Ka - r + M - 1) / M);
    if (!first) cluster_wait();  // the peers have read the last tile's rows
    first = false;
    if (ana) {
      // the synthesis pad and the sub-band signal's end are zeros, as in
      // the composition
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float* dst = own_s + (bg * NB + c) * SP + s0;
#pragma unroll
        for (int i = 0; i < NT; i += 4) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tau = tau0 + s0 + i + j;
            v[j] = (tau >= 0 && tau < T_ana) ? acc[c][i + j] : 0.0f;
          }
          st_vec<4>(dst + i, v);
        }
      }
    }
    cluster_arrive();
    cluster_wait();  // every block's rows are written
    // the whole sub-band tile, row m from block m / MB, over the window
    for (int e = tid; e < M * SP4; e += nthr) {
      const int m = e / SP4;
      const int i = 4 * (e - m * SP4);
      const float* src = cluster_ptr(own_s, m / MB) + (m % MB) * SP + i;
      *reinterpret_cast<float4*>(xp_s + m * SP + i) = ld4(src);
    }
    cluster_arrive();  // done reading the peers' rows
    __syncthreads();   // the tile is whole

    // synthesis: this block's output channels, thread tile (band group bg,
    // steps s0)
    if (tid < BG * (Tt / NT) && s0 < n_out) {
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < NT; ++i) acc[c][i] = 0.0f;
      for (int m = 0; m < M; ++m)
        slide_fma<NB, NT>(acc, ws_s + m * Ks * MB + bg * NB, MB,
                          xp_s + m * SP + s0, Ks);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (s0 + i < n_out) {
          float v[NB];
#pragma unroll
          for (int c = 0; c < NB; ++c) v[c] = gain * acc[c][i];
          st_vec<NB>(out + ((long long)row * T_out + t0 + s0 + i) * M + c0 +
                         bg * NB, v);
        }
      }
    }
    __syncthreads();  // the tile is read: the next window may land
    if (tile + n_clusters < n_tiles) load_window(tile + n_clusters);
    cp_async_commit();
  }
  if (!first) cluster_wait();  // no block exits while a peer reads its rows
  cp_async_wait<0>();           // no copy outlives the block
}

// Dynamic shared memory past 48 KB must be opted into per kernel, or the
// launch is refused (and synchronize() would not say so).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// log2(n) where n is a power of two, else -1
int log2_exact(int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  return (1 << lg) == n ? lg : -1;
}

cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

template <int M>
cudaError_t launch_roundtrip(const RtGeom& g, const Plan& p, const float* x,
                             const float* wa, const float* ws, float* out,
                             int B, int Tx, int Ka, int Ks, int T_ana,
                             int T_out, int pad_a, int pad_left,
                             cudaStream_t stream) {
  cudaError_t err = allow_smem(roundtrip_kernel<M>, p.smem);
  if (err != cudaSuccess) return err;
  roundtrip_kernel<M><<<p.gx, p.threads, p.smem, stream>>>(
      x, wa, ws, out, B, Tx, Ka, Ks, T_ana, T_out, pad_a, pad_left, g.n_sub,
      g.Tt, g.J, g.XR, g.SP);
  return cudaGetLastError();
}

// a launch of K3 at M >= 32 with C = t.C blocks a cluster
cudaLaunchConfig_t rtc_config(const RtcTile& t, int blocks, size_t smem,
                              cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(t.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of tile t (C blocks of t.smem each) the card holds at once
template <int M, int NB, int NT>
cudaError_t rtc_occupancy(const RtcTile& t, int* clusters) {
  auto kernel = roundtrip_cluster_kernel<M, NB, NT>;
  cudaError_t err = allow_smem(kernel, t.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      rtc_config(t, t.C, t.smem, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// the clusters of K3's whole-file tile at M = 32 / 64 the card holds at once
cudaError_t rtc_max_clusters(int M, int Ka, int Ks, int* clusters) {
  const RtcTile t = rtc_tile(M, Ka, Ks, 0);
  *clusters = 0;
  switch (M) {
    case 32: return rtc_occupancy<32, kRtcNB, kRtcNT>(t, clusters);
    case 64: return rtc_occupancy<64, kRtcNB, kRtcNT>(t, clusters);
    default: return cudaErrorInvalidValue;
  }
}

template <int M, int NB, int NT>
cudaError_t launch_roundtrip_cluster(const RtcTile& t, const Plan& p,
                                     const float* x, const float* wa,
                                     const float* ws, float* out, int B,
                                     int Tx, int Ka, int Ks, int T_ana,
                                     int T_out, int pad_a, int pad_left,
                                     cudaStream_t stream) {
  auto kernel = roundtrip_cluster_kernel<M, NB, NT>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      rtc_config(t, p.gx, p.smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, wa, ws, out, B, Tx, Ka, Ks,
                           T_ana, T_out, pad_a, pad_left, t.n_sub, t.Tt, t.J,
                           t.XR, t.SP, t.PS);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of kernel `which` (1 analysis, 2 synthesis,
// 3 round trip) may use: K1's and K3's, and the most of any K2 plan; the
// Python gates mirror this and check against it.
size_t pqmf_smem_bytes(int which, int M, int Mb, int Ka, int Ks) {
  switch (which) {
    case 1: return analysis_smem(M, Mb, Ka);
    case 2: return synthesis_smem(M, Mb, Ks);
    case 3: return M >= kRtcMinBands ? rtc_smem(M, Ka, Ks)
                                     : roundtrip_geom(M, Ka, Ks).smem;
    default: return 0;
  }
}

// The launch plan of kernel `which` for a call with T_out output steps on a
// card of n_sms SMs that holds max_clusters of K3's whole-file clusters at
// once (pqmf_rt_max_clusters; read at M >= 32 only): plan[0..7] = grid x,
// y, z, threads, output steps a tile, K1/K2's NT / K3's sub-band steps a
// tile, K1's phase split / K2's band split / K3's blocks a cluster (1: no
// cluster), dynamic shared memory.  Returns 0, or -1 for an unknown kernel.
int pqmf_launch_plan(int which, int B, int M, int Mb, int Ka, int Ks,
                     int T_out, int n_sms, int max_clusters,
                     long long* plan) {
  Plan p;
  switch (which) {
    case 1: p = analysis_plan(B, M, Mb, Ka, T_out, n_sms); break;
    case 2: p = synthesis_plan(B, M, Mb, Ks, T_out, n_sms); break;
    case 3:
      p = roundtrip_plan(B, M, Ka, Ks, T_out, n_sms, max_clusters);
      break;
    default: return -1;
  }
  const long long v[8] = {p.gx, p.gy, p.gz, p.threads, p.tile_steps, p.aux,
                          p.split, (long long)p.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

const char* pqmf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The clusters of K3's (M = 32, 64) whole-file tile the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters; returns a cudaError_t.
int pqmf_rt_max_clusters(int M, int Ka, int Ks, int* clusters) {
  *clusters = 0;
  if (M < kRtcMinBands || !rtc_fits(M, Ka, Ks))
    return (int)cudaErrorInvalidValue;
  return (int)rtc_max_clusters(M, Ka, Ks, clusters);
}

// x: [B, 1, Tx], zero-padded by pad_left on the left and by zeros past Tx
// on the right; T_out output steps.
int pqmf_analysis_conv(const float* x, const float* w, float* out, int B,
                       int Tx, int M, int Mb, int K, int T_out, int pad_left,
                       int fuse_mask, void* stream) {
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = analysis_plan(B, M, Mb, K, T_out, n_sms);
  const int SG = p.tile_steps / p.aux;
  const int PG = p.threads / (SG * p.split);
  const dim3 grid(p.gx, p.gy, p.gz);
  auto kernel = p.aux == kNT ? analysis_kernel<kNT> : analysis_kernel<4>;
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, p.threads, p.smem, (cudaStream_t)stream>>>(
      x, w, out, B, Tx, M, Mb, K, T_out, pad_left, SG, PG, p.split,
      fuse_mask, log2_exact(M));
  return (int)cudaGetLastError();
}

// x: [B, Mb, Tx], zero-padded by pad_left on the left and by zeros past Tx;
// x_offset is the position of x[..., 0] in the signal whose parity the sign
// mask counts.
int pqmf_synthesis_conv(const float* x, const float* w, float* out, int B,
                        int Mb, int Tx, int M, int K, int T_out,
                        int pad_left, int fuse_mask, int x_offset,
                        void* stream) {
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = synthesis_plan(B, M, Mb, K, T_out, n_sms);
  const int SG = p.tile_steps / p.aux;
  const int PG = p.threads / (SG * p.split);
  const dim3 grid(p.gx, p.gy, p.gz);
  auto kernel = p.aux == kNT ? synthesis_kernel<kNT> : synthesis_kernel<4>;
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, p.threads, p.smem, (cudaStream_t)stream>>>(
      x, w, out, B, Mb, Tx, M, K, T_out, pad_left, SG, PG, p.split,
      fuse_mask, x_offset);
  return (int)cudaGetLastError();
}

// x: [B, 1, Tx], zero-padded by pad_a on the left and by zeros past Tx
// (the analysis input); the sub-bands (T_ana steps) zero-padded by pad_left
// on the left and by zeros past T_ana.  Output [B, T_out, M].
int pqmf_roundtrip_conv(const float* x, const float* wa, const float* ws,
                        float* out, int B, int Tx, int M, int Ka, int Ks,
                        int T_ana, int T_out, int pad_a, int pad_left,
                        void* stream) {
  if (!roundtrip_templated(M)) return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (M >= kRtcMinBands) {
    if (!rtc_fits(M, Ka, Ks)) return (int)cudaErrorInvalidValue;
    bool persist = false;
    const RtcTile t = rtc_choice(B, M, Ka, Ks, T_out, n_sms, &persist);
    int clusters = 0;
    if (persist) {  // as many clusters as the card holds at once, or none
      err = rtc_max_clusters(M, Ka, Ks, &clusters);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    }
    const Plan p = roundtrip_plan(B, M, Ka, Ks, T_out, n_sms, clusters);
    switch (M) {
      case 32:
        err = persist ? launch_roundtrip_cluster<32, kRtcNB, kRtcNT>(
                            t, p, x, wa, ws, out, B, Tx, Ka, Ks, T_ana,
                            T_out, pad_a, pad_left, s)
                      : launch_roundtrip_cluster<32, kRtcSmallNB,
                                                 kRtcSmallNT>(
                            t, p, x, wa, ws, out, B, Tx, Ka, Ks, T_ana,
                            T_out, pad_a, pad_left, s);
        break;
      case 64:
        err = persist ? launch_roundtrip_cluster<64, kRtcNB, kRtcNT>(
                            t, p, x, wa, ws, out, B, Tx, Ka, Ks, T_ana,
                            T_out, pad_a, pad_left, s)
                      : launch_roundtrip_cluster<64, kRtcSmallNB,
                                                 kRtcSmallNT>(
                            t, p, x, wa, ws, out, B, Tx, Ka, Ks, T_ana,
                            T_out, pad_a, pad_left, s);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)err;
  }
  const Plan p = roundtrip_plan(B, M, Ka, Ks, T_out, n_sms, 0);
  const RtGeom g = roundtrip_geom(M, Ka, Ks);
  if (g.Tt <= 0) return (int)cudaErrorInvalidValue;
  switch (M) {
    case 2: err = launch_roundtrip<2>(g, p, x, wa, ws, out, B, Tx, Ka, Ks,
                                      T_ana, T_out, pad_a, pad_left, s); break;
    case 4: err = launch_roundtrip<4>(g, p, x, wa, ws, out, B, Tx, Ka, Ks,
                                      T_ana, T_out, pad_a, pad_left, s); break;
    case 8: err = launch_roundtrip<8>(g, p, x, wa, ws, out, B, Tx, Ka, Ks,
                                      T_ana, T_out, pad_a, pad_left, s); break;
    case 16: err = launch_roundtrip<16>(g, p, x, wa, ws, out, B, Tx, Ka, Ks,
                                        T_ana, T_out, pad_a, pad_left, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
