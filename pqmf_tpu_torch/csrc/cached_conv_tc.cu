// Hand-written Hopper (sm_90a) tensor-core kernels for the "bf16x3" and
// "default" precision tiers of the PQMF streaming path's three
// convolutions.  Plain C interface, built with nvcc beside cached_conv.cu
// into one library and loaded with ctypes (pqmf_tpu_torch/kernels/_build.py);
// the Python wrappers, their plain versions, the bank arrangement and a
// mirror of every launch plan live in pqmf_tpu_torch/kernels/cached_conv.py.
//
// K1t analysis  replaces pqmf_tpu/kernels/cached_conv.py:strided_analysis_conv
//   at mxu_precision "bf16x3" / "default" (_prec_dot, :93)
// K2t synthesis replaces pqmf_tpu/kernels/cached_conv.py:dense_synthesis_conv
//   at those tiers (_slice_dots, :207)
// K3t roundtrip replaces pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv
//   at those tiers (_fused_roundtrip_single, :715, its pallas_call :751:
//   the f32 mid is split again)
//
// The tiers: every f32 operand is split into hi = bf16(a) and lo =
// bf16(a - hi), both rounded to nearest even (JAX's _split_bf16).  "bf16x3"
// sums hi*hi + hi*lo + lo*hi, "default" hi*hi, with f32 sums, on the tensor
// cores (mma.sync m16n8k16 bf16 -> f32): PASSES = 3 or 1.  Each k-step sums
// into a fresh register that joins the accumulator by an f32 add: the tensor
// cores' own f32 accumulation truncates.
//
// Each convolution is a GEMM whose A operand is a strided Hankel matrix of
// one window in shared memory, A[t, q] = buf[S*t + q]:
// - K1t: buf is the signal from M*t0 - pad_left on (zeros outside it),
//   S = M, q < K, B[q, c] = w[c, 0, q]; the sign mask goes on the output.
// - K2t: buf is the sub-band window time-major, win[tau][m], from t0 -
//   pad_left on, the input sign mask applied; S = Mb, q = k*Mb + m,
//   B[q, c] = w[M-1-c, m, k] (band flip); the gain M goes on the sums.
// - K3t: K1t's GEMM (its signal window from M*t0 - pad_a on) writes its
//   sub-band tile time-major, split again, straight from the sums into
//   shared memory, where it is K2t's window; the two sign masks cancel, so
//   neither is applied.
// The reduction is padded to a multiple of 16 with zero bank columns, and
// every window element a padded column reads is staged (input or zero): 0
// times stale shared memory could be 0 * NaN.
//
// What bounds them on the H100: a tier's work is the f32 kernel's FMAs x
// PASSES at the 989 TFLOP/s bf16 dense tensor-core peak, so a whole-file
// call is HBM-bound at "default" and near the line at "bf16x3"; a call of
// one host block (T_out = 512) is bound by latency: the copies, the k-steps
// a warp walks one after another, and how many SMs it reaches.
//
// K1t and K2t (redesigned for Hopper):
// - B comes arranged: cached_conv.arrange_tc_bank builds the bank once, when
//   the weights are installed, as bf16 hi (and lo) in the order of the mma's
//   B fragments, [half][channel block][k-step][lane][4*NN], zero-padded,
//   band flip and column order applied.  A lane's fragments of a k-step are
//   one 16-byte load (NN = 2 n8 tiles), read by every m16 tile the warp
//   computes.  A block that walks many tiles, or one of a call whose
//   blocks the card holds at once, copies its channel block of it to shared
//   memory with 16-byte cp.async (no conversion); past that (16 streams:
//   512 blocks) each warp reads only its slice from L2, as it does for a
//   bank too large to stage.
// - The window is copied raw (f32, cp.async, 16 bytes where aligned, the
//   zero pad as the copies' zero-fill), then split once into bf16 hi/lo
//   halves (K2t transposes it to time-major and applies the sign mask in
//   that pass; index splits by shift and mask where Mb = 2^k).  The next
//   tile's raw copy is issued before the current tile's mma, so on whole
//   files it overlaps them.
// - A fragments come from the split window with ldmatrix.x4 where the
//   Hankel row stride is 16-byte aligned (S % 8 == 0), 32-bit loads where S
//   is even, 16-bit loads otherwise.  For ldmatrix the window's 16-byte
//   chunks are swizzled (swizzle()), so the 8 rows of a matrix, S/8 chunks
//   apart, hit 8 distinct bank groups.
// - The launch plan follows the call (tc_plan): a block is 4 warps, as WM
//   row groups x WK slices of the reduction.  A small call (one host block:
//   32 m16 tiles) splits the reduction over the warps (WK up to 4, summed in
//   shared memory in a fixed order) and runs one tile a block, so it reaches
//   32-512 blocks; a whole file runs persistent blocks of 4 warps x 2 m16
//   tiles (128 output steps a tile) that stage their bank chunk once.
//
// K3t (redesigned for Hopper), one kernel roundtrip_tc_kernel<P,NN,MT,LD>
// on K1t/K2t's parts (tc_mma, the swizzle, the raw cp.async window):
// - Both banks come arranged (arrange_tc_bank of the analysis and synthesis
//   banks: exactly K1t's and K2t's, which StreamingPQMF and PQMF keep) and
//   are staged as they are by 16-byte cp.async, once a block, where the
//   block walks tiles or the card holds every block; no tap is split,
//   divided or reordered here.  One 16-byte B load a lane a k-step feeds
//   two n8 tiles.
// - A fragments by ldmatrix.x4 (M = 8, 16; 32-bit pairs at M = 2, 4) from
//   two swizzled windows: the split signal window and the split sub-band
//   tile, which the analysis epilogue writes through the same map.  Where
//   the analysis is one warp item each, the sub-band tile takes the split
//   window's place (the window is read by then): at M = 16, bf16x3 a whole-
//   file block takes 104 KB, the banks 67.6 KB of it, so 2 fit an SM.
// - The raw signal window (f32, the analysis pad as the copy's zero-fill)
//   of the next tile is copied while this tile's mma run; no phase waits
//   on device memory but the first.
// - The plan follows the call (rt_tc_choice): whole files run persistent
//   blocks of 8 warps over tiles of 256 sub-band steps, 224 output steps
//   at M = 16 (the halo's recomputed 32 analysis rows: 1.14x), 2 m16 tiles
//   a warp item; host blocks take tiles of 16-64 output steps, one tile a
//   block (32 blocks at [1,1,8704]), and split each phase's reduction over
//   the idle warps, summed in shared memory in slice order (deterministic).
// - What bounds it: at 60 s the work of both GEMMs (bf16x3: 3 mma a k-step)
//   near the bf16 line, plus the halo; a host block's latency: the banks'
//   copy, then the dependent k-steps of two phases.
// - At M = 32 and 64 each bank has 2 or 4 channel blocks of 16 bands (268
//   KB and 1.07 MB at bf16x3: past a block's shared memory), so K3t
//   replaces fused_roundtrip_conv there (pqmf_tpu/kernels/cached_conv.py
//   :794; _fused_roundtrip_single :715, its pallas_call :751) with a
//   thread-block cluster a tile (the same kernel, C a template argument;
//   C = 1 up to M = 16).  It is bound by the bytes of its operands: at
//   default, and at bf16x3 past the bank, the tensor cores wait on the
//   shared-memory reads of the A fragments and the copies of a bank none
//   of whose blocks holds more than a slice; the cluster split keeps each
//   block's slice of both banks resident and reads every A fragment once
//   for all its channels.  Block rank rho computes output channels
//   [8 NN rho, 8 NN (rho + 1)): a whole channel block (NN = 2, C = M/16)
//   where that slice of both banks fits beside a 96-step whole-file tile,
//   else one n8 tile (NN = 1, C = M/8: M = 64 at bf16x3); it stages its
//   slice once a launch (16- or 8-byte cp.async of the arranged words; at
//   "default" the hi half only).  Every block splits the whole window and
//   computes its channels of every row into the split sub-band tile;
//   after a cluster barrier each block copies the other blocks' 16-byte
//   chunks of that tile through distributed shared memory into its own
//   (the same swizzled places), and arrives at a second barrier, whose
//   wait comes before it overwrites its chunks or exits (a peer may still
//   read them); then it computes its output channels.  Its sums run in
//   the slice order of M <= 16.  Whole files take the largest tile of up
//   to 256 sub-band steps that fits beside the bank slices (at M = 64:
//   128 steps), host blocks 16-64 output steps a cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "rt_plan.h"

namespace {

constexpr int kTcThreads = 128;                // K1t/K2t: threads a block
constexpr int kTcWarps = kTcThreads / 32;
constexpr long long kTcBankBytes = 144 * 1024; // most arranged bank a block stages
constexpr int kTcFillWarps = 8;   // small calls: warps an SM should get
constexpr int kTcPersistM16 = 16; // whole files: from n_sms * 16 m16 tiles on
constexpr int kRtTcThreads = 256;              // K3t: threads a block
constexpr int kRtTcWarps = kRtTcThreads / 32;
constexpr int kRtTcSub = 256;     // K3t whole files: sub-band steps a tile
constexpr int kRtTcClusterBands = 32;  // K3t: from M = 32 a cluster a tile
constexpr int kRtTcBlockNN = 2;   // n8 tiles a cluster's block, where it fits
constexpr int kRtTcMinPersist = 96;  // ... beside a whole-file tile this long
// blocks an SM the register allocation plans for: without them ptxas kept
// K1t at 48 registers and spilled one (4 bytes)
constexpr int kTcMinBlocks = 4;
constexpr int kRtTcMinBlocks = 2;
constexpr long long kSmemLimit = 232448;       // shared memory one block may use
constexpr size_t kSmemPerSm = 233472;          // shared memory of one SM
constexpr size_t kStaticSmem = 48 * 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }
inline int min_i(int a, int b) { return a < b ? a : b; }
inline int max_i(int a, int b) { return a > b ? a : b; }
inline long long max_ll(long long a, long long b) { return a > b ? a : b; }

// A launch, in the layout of cached_conv.cu's Plan: grid, threads, output
// steps a tile, K1t/K2t's reduction split WK (K3t's sub-band steps a
// tile), K1t/K2t's output channels a block (K3t: 1), dynamic shared memory.
struct Plan {
  int gx, gy, gz, threads, tile_steps, aux, split;
  size_t smem;
  bool stage;  // K1t/K2t: the block stages its bank chunk
};

// K1t (kind 1) / K2t (kind 2): a conv of stride S whose reduction runs over
// Q terms into N output channels.  The reduction padded to Qp = 16 n_k;
// NN n8 tiles a channel block, n_cb blocks; the arranged bank of one
// channel block takes bank_bytes (both halves) and is staged when it fits
// beside the largest window of any plan.
struct TcGeom {
  int kind, S, Qp, n_k, NN, n_cb;
  long long bank_bytes;
  bool stage;
};

// The window of a tile of R rows: nT steps of S elements (WL, split
// halves), its raw copy (K2t: Mb rows of XR, band-major as the input).
struct TcWin {
  int nT, WL, XR, raw;
};

TcWin tc_win(const TcGeom& g, int R) {
  TcWin w;
  w.nT = R - 1 + cdiv(g.Qp, g.S);
  w.WL = round64(g.S * w.nT);  // whole groups of 8 swizzled 16-byte chunks
  w.XR = g.kind == 2 ? round8(w.nT) + 4 : 0;  // 4 mod 8: 2-way conflicts at most
  w.raw = g.kind == 2 ? g.S * w.XR : w.WL;
  return w;
}

// the plans a block can take: (MT m16 tiles a warp, WK reduction slices)
constexpr int kTcShapes[4][2] = {{2, 1}, {1, 1}, {1, 2}, {1, 4}};

long long tc_rest_bytes(const TcGeom& g, int MT, int WK) {
  const int WM = kTcWarps / WK;
  const TcWin w = tc_win(g, 16 * MT * WM);
  return 4LL * w.raw + 4LL * w.WL +
         16LL * (WK - 1) * WM * 32 * MT * g.NN;
}

long long tc_rest_max(const TcGeom& g) {
  long long m = 0;
  for (const auto& s : kTcShapes) m = max_ll(m, tc_rest_bytes(g, s[0], s[1]));
  return m;
}

TcGeom tc_geom(int kind, int S, int Q, int N) {
  TcGeom g;
  g.kind = kind;
  g.S = S;
  g.Qp = round16(Q);
  g.n_k = g.Qp / 16;
  g.NN = N > 8 ? 2 : 1;
  g.n_cb = cdiv(N, 8 * g.NN);
  g.bank_bytes = 2LL * g.n_k * 32 * 4 * g.NN * 2;
  g.stage = g.bank_bytes <= kTcBankBytes &&
            g.bank_bytes + tc_rest_max(g) <= kSmemLimit;
  return g;
}

// the most shared memory any plan of this geometry takes (the gate)
long long tc_smem_gate(const TcGeom& g) {
  return (g.stage ? g.bank_bytes : 0) + tc_rest_max(g);
}

// (MT, WK, persistent) for a call of B rows of T_out steps
struct TcChoice {
  int MT, WK;
  bool persist;
};

TcChoice tc_choice(const TcGeom& g, int B, int T_out, int n_sms) {
  const long long m16 = (long long)B * cdiv(T_out, 16) * g.n_cb;
  if (m16 >= (long long)n_sms * kTcPersistM16) return {2, 1, true};
  int wk = 1;
  while (wk < kTcWarps && 2 * wk <= g.n_k &&
         m16 * wk < (long long)n_sms * kTcFillWarps)
    wk *= 2;
  return {1, wk, false};
}

Plan tc_plan(const TcGeom& g, int B, int T_out, int n_sms) {
  const TcChoice c = tc_choice(g, B, T_out, n_sms);
  const int R = 16 * c.MT * (kTcWarps / c.WK);
  Plan p;
  p.gy = g.n_cb;
  p.gz = 1;
  p.threads = kTcThreads;
  p.tile_steps = R;
  p.aux = c.WK;
  p.split = 8 * g.NN;
  const int tiles = B * cdiv(T_out, R);
  // a block stages its bank chunk where it walks many tiles or where the
  // card holds every block at once; past that, as at 16 streams (512
  // blocks), each warp reads only its slice from L2 (0.5-0.7 us less at
  // [16, 16, 544] on an H100)
  p.stage = g.stage && (c.persist || (long long)tiles * p.gy <= n_sms);
  p.smem = (size_t)((p.stage ? g.bank_bytes : 0) + tc_rest_bytes(g, c.MT, c.WK));
  const int per_sm = max_i(1, min_i(2048 / kTcThreads,
                                    (int)(kSmemPerSm / (p.smem + 1024))));
  p.gx = c.persist ? min_i(tiles, max_i(1, n_sms * per_sm / p.gy)) : tiles;
  return p;
}

// K3t: the two arranged banks (n_cb channel blocks of NN n8 tiles each:
// one up to M = 16, 2 and 4 at M = 32 and 64), their k-steps, and the
// sub-band rows one output step reads (rows_s).  Up to M = 16 one block a
// tile (C = 1) stages both banks where there is one channel block and they
// fit beside the largest tile of any plan, else each warp reads its
// fragments from L2.  At M = 32 and 64 a cluster of C = M / (8 bNN) blocks
// a tile, each with bNN n8 tiles (a channel block, bNN = 2, where it fits;
// else half of one) of both banks, staged: halves 2 at bf16x3, 1 at
// default (up to M = 16 the bytes of both are budgeted).
struct RtTcGeom {
  int M, Qa, n_ka, n_ks, NN, n_cb, rows_s, C, bNN, halves;
  long long bank_bytes;  // of one block
  bool stage;
};

// A K3t tile: Tt output steps (synthesis rows) of n_sub sub-band steps
// (analysis rows), MT m16 tiles x the block's channels a warp item, each
// phase's reduction split over WK warps (WKa analysis, WKs synthesis); the
// split window of WL elements (raw f32 and bf16 halves), the split
// sub-band tile (SL elements a half; 0: it takes the split window's place,
// which it may where the analysis is one item a warp) and the partial sums
// of the split reductions.
struct RtTcTile {
  int Tt, n_sub, MT, WKa, WKs, WL, SL;
  long long rest;  // bytes besides the banks
};

// warps a reduction of n_k k-steps is split over, for `items` m16 groups
int rt_tc_wk(int items, int n_k) {
  int wk = 1;
  while (2 * wk * items <= kRtTcWarps && 2 * wk <= n_k) wk *= 2;
  return wk;
}

RtTcTile rt_tc_tile(const RtTcGeom& g, int Tt, bool persist) {
  RtTcTile t;
  t.Tt = Tt;
  t.MT = persist ? 2 : 1;
  const int r = 16 * t.MT;
  t.n_sub = cdiv(Tt - 1 + g.rows_s, r) * r;
  t.WL = round64(g.M * (t.n_sub - 1) + 16 * g.n_ka);
  const int ga = t.n_sub / r, gs = Tt / r;  // items: one channel block a block
  t.WKa = rt_tc_wk(ga, g.n_ka);
  t.WKs = rt_tc_wk(gs, g.n_ks);
  t.SL = ga * t.WKa <= kRtTcWarps ? 0 : round64(g.M * t.n_sub);
  const long long red = (long long)max_i((t.WKa - 1) * ga, (t.WKs - 1) * gs) *
                        32 * t.MT * g.bNN * 4;
  t.rest = 4LL * t.WL + 4LL * t.WL + 4LL * t.SL + 4 * red;
  return t;
}

// whole files: tiles of kRtTcSub sub-band steps (more where one output step
// reads more), as many output steps of them as are whole m16 pairs; a
// cluster's block takes the largest such tile that fits beside its banks
int rt_tc_persist_steps(const RtTcGeom& g) {
  const int n_sub = cdiv(max_i(kRtTcSub, 32 + g.rows_s - 1), 32) * 32;
  int Tt = (n_sub - g.rows_s + 1) / 32 * 32;
  if (g.C > 1)
    while (Tt > 32 &&
           g.bank_bytes + rt_tc_tile(g, Tt, true).rest > kSmemLimit)
      Tt -= 32;
  return Tt;
}

// the shapes a plan can take: whole files, and small calls' 16-64 steps
// (rt_plan.h)

long long rt_tc_rest_max(const RtTcGeom& g) {
  long long m = rt_tc_tile(g, rt_tc_persist_steps(g), true).rest;
  for (int Tt : kRtSmall) m = max_ll(m, rt_tc_tile(g, Tt, false).rest);
  return m;
}

long long rt_tc_smem_gate(const RtTcGeom& g) {
  return (g.stage ? g.bank_bytes : 0) + rt_tc_rest_max(g);
}

RtTcGeom rt_tc_geom(int M, int Ka, int Ks, int passes) {
  RtTcGeom g;
  g.M = M;
  g.Qa = round16(Ka);
  g.n_ka = g.Qa / 16;
  g.n_ks = round16(M * Ks) / 16;
  g.NN = M > 8 ? 2 : 1;
  g.n_cb = cdiv(M, 8 * g.NN);
  g.rows_s = cdiv(16 * g.n_ks, M);
  g.halves = M >= kRtTcClusterBands && passes == 1 ? 1 : 2;
  if (M < kRtTcClusterBands) {
    g.C = 1;
    g.bNN = g.NN;
    g.bank_bytes = 2LL * (g.n_ka + g.n_ks) * g.n_cb * 32 * 4 * g.NN * 2;
    g.stage = g.n_cb == 1 && g.bank_bytes + rt_tc_rest_max(g) <= kSmemLimit;
    return g;
  }
  // a cluster: blocks of kRtTcBlockNN n8 tiles where that slice of the
  // banks fits beside a whole-file tile of kRtTcMinPersist steps and every
  // host-block tile, else of one
  for (int bNN = kRtTcBlockNN; bNN >= 1; bNN /= 2) {
    g.bNN = bNN;
    g.C = M / (8 * bNN);
    g.bank_bytes = 2LL * g.halves * (g.n_ka + g.n_ks) * 32 * 4 * bNN;
    g.stage = true;
    if (bNN == 1 || (rt_tc_persist_steps(g) >= kRtTcMinPersist &&
                     rt_tc_smem_gate(g) <= kSmemLimit))
      break;
  }
  return g;
}

bool rt_tc_templated(int M) {
  return M == 2 || M == 4 || M == 8 || M == 16 || M == 32 || M == 64;
}

// A call of B rows of T_out output steps (rt_plan.h, counting a cluster's
// blocks): whole files run persistent blocks (clusters) over
// rt_tc_persist_steps tiles; a smaller call (host blocks) one tile of
// 16-64 steps a block (a cluster).
RtTcTile rt_tc_choice(const RtTcGeom& g, int B, int T_out, int n_sms,
                      bool* persist) {
  const int Tt = rt_call_tile(B, T_out, n_sms, g.C);
  *persist = Tt == 0;
  return rt_tc_tile(g, *persist ? rt_tc_persist_steps(g) : Tt, *persist);
}

// max_clusters: at M >= 32, the clusters of the whole-file tile the card
// holds at once (cudaOccupancyMaxActiveClusters)
Plan rt_tc_plan(const RtTcGeom& g, int B, int T_out, int n_sms,
                int max_clusters) {
  bool persist = false;
  const RtTcTile t = rt_tc_choice(g, B, T_out, n_sms, &persist);
  const int n_tiles = B * cdiv(T_out, t.Tt);
  Plan p;
  // staged where a block walks many tiles or the card holds every block
  p.stage = g.stage && (persist || n_tiles <= n_sms || g.C > 1);
  p.smem = (size_t)((p.stage ? g.bank_bytes : 0) + t.rest);
  if (g.C > 1) {
    p.gx = (persist ? min_i(n_tiles, max_i(0, max_clusters)) : n_tiles) * g.C;
  } else {
    const int per_sm = max_i(1, min_i(2048 / kRtTcThreads,
                                      (int)(kSmemPerSm / (p.smem + 1024))));
    p.gx = persist ? min_i(n_tiles, n_sms * per_sm) : n_tiles;
  }
  p.gy = 1;
  p.gz = 1;
  p.threads = kRtTcThreads;
  p.tile_steps = t.Tt;
  p.aux = t.n_sub;
  p.split = g.C;
  return p;
}

// ---------------------------------------------------------------------------
// the split, the fragment loads and the mma the kernels share
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the halves of v0, v1 at the even index i, one 32-bit store each: hi (and
// lo at PASSES == 3), to nearest even; v - hi is exact in f32
template <int P>
__device__ __forceinline__ void put_split2(uint16_t* h, uint16_t* l, int i,
                                           float v0, float v1) {
  const uint16_t h0 = bf16_bits(v0), h1 = bf16_bits(v1);
  *reinterpret_cast<uint32_t*>(h + i) = (uint32_t)h0 | ((uint32_t)h1 << 16);
  if (P == 3) {
    const uint16_t l0 =
        bf16_bits(v0 - __bfloat162float(__ushort_as_bfloat16(h0)));
    const uint16_t l1 =
        bf16_bits(v1 - __bfloat162float(__ushort_as_bfloat16(h1)));
    *reinterpret_cast<uint32_t*>(l + i) = (uint32_t)l0 | ((uint32_t)l1 << 16);
  }
}

// two consecutive bf16 (the lower index in the low half), one 32-bit load
// where p is 4-byte aligned
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the four 8x8 matrices of an m16k16 A fragment, rows given by the lanes
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// 16 bytes, of which the first `bytes` are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// 8 bytes
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The cluster barrier in two halves (as in cached_conv.cu): every thread of
// the cluster arrives (release), then waits (acquire) for all; a thread's
// arrivals and waits alternate.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// p (this block's shared memory) at the same offset in the shared memory of
// the cluster's block `rank` (distributed shared memory, a generic address)
__device__ __forceinline__ const void* cluster_ptr(const void* p, int rank) {
  unsigned long long r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<const void*>(r);
}

// q = e / n and r = e % n, by a shift and a mask where n = 2^lg (lg >= 0)
__device__ __forceinline__ void div_mod(int e, int n, int lg, int& q,
                                        int& r) {
  if (lg >= 0) {
    q = e >> lg;
    r = e & (n - 1);
  } else {
    q = e / n;
    r = e - q * n;
  }
}

// The split window's 16-byte chunk u lies at chunk u ^ ((u >> 3) & swz):
// the 8 rows an ldmatrix reads are S/8 chunks apart, which without the
// swizzle meet in min(S/8, 8) ways on the same banks (2 at S = 16, 8 at
// S = 64); with swz = min(S/8, 8) - 1 (S a power of two) they are 8
// distinct chunks.  Only where A comes by ldmatrix (swz = 0 otherwise).
__device__ __forceinline__ int swizzle(int u, int swz) {
  return u ^ ((u >> 3) & swz);
}

// one lane's B fragments of a k-step, 4*NN bf16 of the arranged bank: for
// n8 tile nn, words 2nn and 2nn+1 are the mma's b0 and b1
template <int NN>
__device__ __forceinline__ void ld_b(uint32_t (&b)[2 * NN],
                                     const uint16_t* p) {
  if constexpr (NN == 2) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    b[0] = v.x; b[1] = v.y;
  }
}

// acc[mt][nn] += rows r0 + 16mt .. r0 + 16mt + 15 of A times B over the
// k-steps ks0 .. ks1-1.  A[t, q] = a[S*t + q] (halves ah, al, in shared
// memory); bank is the arranged B of this channel block (the lo half
// `plane` elements on).  LD: 0 ldmatrix.x4 (S % 8 == 0), 1 32-bit pairs
// (S even), 2 16-bit loads.  P = 3: hi*hi + hi*lo + lo*hi; P = 1: hi*hi.
template <int P, int NN, int MT, int LD>
__device__ __forceinline__ void tc_mma(float (&acc)[MT][NN][4],
                                       const uint16_t* ah, const uint16_t* al,
                                       int S, int swz, int r0,
                                       const uint16_t* bank, int plane,
                                       int ks0, int ks1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // ldmatrix: lane l gives row (l & 15), 16-byte chunk (l >> 4) of the
  // tile, chunk u0 of the window at k-step 0 (two chunks a k-step)
  const int u0 = (S * (r0 + (lane & 15))) / 8 + (lane >> 4);
  const unsigned sh = smem_addr(ah);
  const unsigned sl = smem_addr(al);
  const int ao = S * (r0 + g) + 2 * tq;
  const uint16_t* bp = bank + lane * 4 * NN;
#pragma unroll 2
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k = 16 * ks;
    uint32_t bh[2 * NN], bl[2 * NN];
    ld_b<NN>(bh, bp + ks * 128 * NN);
    if (P == 3) ld_b<NN>(bl, bp + plane + ks * 128 * NN);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a_h[4], a_l[4];
      if (LD == 0) {
        const unsigned off = 16u * swizzle(u0 + 2 * S * mt + 2 * ks, swz);
        ldsm_x4(a_h, sh + off);
        if (P == 3) ldsm_x4(a_l, sl + off);
      } else {
        const int o = ao + 16 * S * mt + k;
        const int o8 = o + 8 * S;
        a_h[0] = ld_pair(ah + o, LD == 1);
        a_h[1] = ld_pair(ah + o8, LD == 1);
        a_h[2] = ld_pair(ah + o + 8, LD == 1);
        a_h[3] = ld_pair(ah + o8 + 8, LD == 1);
        if (P == 3) {
          a_l[0] = ld_pair(al + o, LD == 1);
          a_l[1] = ld_pair(al + o8, LD == 1);
          a_l[2] = ld_pair(al + o + 8, LD == 1);
          a_l[3] = ld_pair(al + o8 + 8, LD == 1);
        }
      }
#pragma unroll
      for (int nn = 0; nn < NN; ++nn) {
        // the step's sum starts from zero and joins acc by f32 adds,
        // rounded to nearest: the tensor cores' f32 accumulation truncates
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (P == 3) {
          mma_bf16(t, a_h, bl[2 * nn], bl[2 * nn + 1]);
          mma_bf16(t, a_l, bh[2 * nn], bh[2 * nn + 1]);
        }
        mma_bf16(t, a_h, bh[2 * nn], bh[2 * nn + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nn][j] += t[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1t and K2t.  Block (tile walk, channel block): warp w computes the MT
// m16 tiles of row group w % WM over reduction slice w / WM; the slices
// meet in shared memory, summed in slice order.  Tiles (batch row, R output
// steps) are walked with a stride of the grid: one a block for small calls.
// ---------------------------------------------------------------------------
struct TcArgs {
  const float* x;
  const uint16_t* bank;  // arranged: [half][n_cb][n_k][32][4*NN]
  float* out;
  int B, Tx;             // input rows (K2t: of Mb bands) and their length
  int S, lgS;            // stride (K1t: M; K2t: Mb) and log2 of it, or -1
  int N;                 // output channels (K1t: Mb; K2t: M)
  int T_out, pad_left, fuse_mask, x_offset;
  int n_k, n_cb, WK, nT, WL, XR, raw, stage;
  int swz;               // the split window's swizzle (0: none)
};

template <int P, int NN, int MT, int LD, int KIND>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
conv_tc_kernel(const TcArgs a) {
  extern __shared__ float4 tc_smem[];
  constexpr int CB = 8 * NN;
  const int WM = kTcWarps / a.WK;
  const int R = 16 * MT * WM;
  const int chunk = a.n_k * 128 * NN;  // bank elements of one half, one block
  const int cb = blockIdx.y;
  uint16_t* bank_s = reinterpret_cast<uint16_t*>(tc_smem);
  float* raw = reinterpret_cast<float*>(bank_s + (a.stage ? 2 * chunk : 0));
  uint16_t* xh = reinterpret_cast<uint16_t*>(raw + a.raw);
  uint16_t* xl = xh + a.WL;
  float* red = reinterpret_cast<float*>(xl + a.WL);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % WM;
  const int wk = warp / WM;
  const int ks0 = a.n_k * wk / a.WK;
  const int ks1 = a.n_k * (wk + 1) / a.WK;
  const int tiles_x = cdiv(a.T_out, R);
  const int n_tiles = a.B * tiles_x;
  const int c0 = cb * CB;

  const uint16_t* bank = a.bank + (long long)cb * chunk;
  int plane = a.n_cb * chunk;
  if (a.stage) {  // this channel block's bank, both halves, as it is
    for (int h = 0; h < (P == 3 ? 2 : 1); ++h) {
      const uint16_t* src = a.bank + ((long long)h * a.n_cb + cb) * chunk;
#pragma unroll 4
      for (int i = tid; i < chunk / 8; i += kTcThreads)
        cp_async16(bank_s + h * chunk + 8 * i, src + 8 * i, 16);
    }
    bank = bank_s;
    plane = chunk;
  }

  // the raw window of tile `tl`, zeros outside the input: K1t the signal
  // from M*t0 - pad_left on; K2t each band's steps from t0 - pad_left on
  auto copy_window = [&](int tl) {
    const int b = tl / tiles_x;
    const int t0 = (tl - b * tiles_x) * R;
    if (KIND == 1) {
      const long long p0 = (long long)t0 * a.S - a.pad_left;
      const float* xb = a.x + (long long)b * a.Tx;
      if ((p0 & 3) == 0 && (a.Tx & 3) == 0 &&
          ((unsigned long long)a.x & 15) == 0) {
        // whole 4-sample groups lie inside or outside the input
#pragma unroll 4
        for (int i = tid; i < a.WL / 4; i += kTcThreads) {
          const long long p = p0 + 4 * i;
          const bool in = p >= 0 && p < a.Tx;
          cp_async16(raw + 4 * i, in ? xb + p : a.x, in ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int i = tid; i < a.WL; i += kTcThreads) {
          const long long p = p0 + i;
          const bool in = p >= 0 && p < a.Tx;
          cp_async4(raw + i, in ? xb + p : a.x, in ? 4 : 0);
        }
      }
    } else {
      const int s0 = t0 - a.pad_left;
      const float* xb = a.x + (long long)b * a.S * a.Tx;
      if ((s0 & 3) == 0 && (a.Tx & 3) == 0 &&
          ((unsigned long long)a.x & 15) == 0) {
        const int g4 = (a.nT + 3) >> 2;  // groups of 4 steps a band
#pragma unroll 4
        for (int e = tid; e < a.S * g4; e += kTcThreads) {
          const int m = e / g4;
          const int s = s0 + 4 * (e - m * g4);
          const bool in = s >= 0 && s < a.Tx;
          cp_async16(raw + m * a.XR + 4 * (e - m * g4),
                     in ? xb + (long long)m * a.Tx + s : a.x, in ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < a.S * a.nT; e += kTcThreads) {
          const int m = e / a.nT;
          const int tau = e - m * a.nT;
          const int s = s0 + tau;
          const bool in = s >= 0 && s < a.Tx;
          cp_async4(raw + m * a.XR + tau,
                    in ? xb + (long long)m * a.Tx + s : a.x, in ? 4 : 0);
        }
      }
    }
  };

  if (blockIdx.x < n_tiles) copy_window(blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_x;
    const int t0 = (tile - b * tiles_x) * R;
    cp_async_wait_all();
    __syncthreads();  // the raw window (and the bank) are in; the last
                      // tile's reads of the halves are done
    // the split, two elements a thread: K1t in place, K2t to time-major
    // win[tau*Mb + m] with the input sign mask by the sample's position
    if (KIND == 1) {
      for (int i = 2 * tid; i < a.WL; i += 2 * kTcThreads) {
        const float2 v = *reinterpret_cast<const float2*>(raw + i);
        put_split2<P>(xh, xl, 8 * swizzle(i >> 3, a.swz) + (i & 7), v.x,
                      v.y);
      }
    } else {
      for (int i = 2 * tid; i < a.WL; i += 2 * kTcThreads) {
        float v[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          int tau, m;
          div_mod(i + d, a.S, a.lgS, tau, m);
          float u = tau < a.nT ? raw[m * a.XR + tau] : 0.0f;
          if (a.fuse_mask && (m & 1) &&
              !((t0 + tau - a.pad_left + a.x_offset) & 1))
            u = -u;
          v[d] = u;
        }
        put_split2<P>(xh, xl, 8 * swizzle(i >> 3, a.swz) + (i & 7), v[0],
                      v[1]);
      }
    }
    __syncthreads();
    if (tile + gridDim.x < n_tiles) copy_window(tile + gridDim.x);
    cp_async_commit();

    float acc[MT][NN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nn][j] = 0.0f;
    tc_mma<P, NN, MT, LD>(acc, xh, xl, a.S, a.swz, 16 * MT * wm, bank,
                          plane, ks0, ks1);
    if (a.WK > 1) {  // slices 1.. to shared memory; slice 0 sums in order
      float* rp = red + (wm * (a.WK - 1)) * 32 * MT * NN * 4 + lane;
      if (wk > 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nn = 0; nn < NN; ++nn)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              rp[((wk - 1) * MT * NN * 4 + (mt * NN + nn) * 4 + j) * 32] =
                  acc[mt][nn][j];
      }
      __syncthreads();
      if (wk > 0) continue;
      for (int s = 0; s < a.WK - 1; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nn = 0; nn < NN; ++nn)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[mt][nn][j] += rp[(s * MT * NN * 4 + (mt * NN + nn) * 4 + j) * 32];
    }
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + 16 * (MT * wm + mt) + g + 8 * h;
          const int c = c0 + nn * 8 + 2 * tq;
          if (t >= a.T_out) continue;
          const float v0 = acc[mt][nn][2 * h], v1 = acc[mt][nn][2 * h + 1];
          if (KIND == 1) {
            // reverse_half on the output: -1 where the band is odd and t even
            const float s = a.fuse_mask && !(t & 1) ? -1.0f : 1.0f;
            float* o = a.out + ((long long)b * a.N + c) * a.T_out + t;
            if (c < a.N) o[0] = v0;
            if (c + 1 < a.N) o[a.T_out] = s * v1;
          } else {
            const float gain = (float)a.N;
            float* o = a.out + ((long long)b * a.T_out + t) * a.N + c;
            if ((a.N & 1) == 0 && c + 1 < a.N) {
              *reinterpret_cast<float2*>(o) =
                  make_float2(gain * v0, gain * v1);
            } else {
              if (c < a.N) o[0] = gain * v0;
              if (c + 1 < a.N) o[1] = gain * v1;
            }
          }
        }
  }
  cp_async_wait_all();  // no copy outlives the block
}

// ---------------------------------------------------------------------------
// K3t: fused round trip.  Block (tile walk): a tile is Tt output steps of
// one batch row.  Per tile the raw window of the signal lands by cp.async
// (issued during the previous tile's mma), is split once into the swizzled
// bf16 halves, and the analysis GEMM (A rows = n_sub sub-band steps, B =
// the arranged analysis bank) writes the sub-band tile split again, time-
// major and swizzled, where the synthesis GEMM (A rows = Tt output steps,
// B = the arranged synthesis bank) reads it.  Warps take items of MT m16
// tiles x one of WK slices of a phase's reduction; slices meet in shared
// memory, summed in slice order.
// ---------------------------------------------------------------------------
struct RtTcArgs {
  const float* x;
  const uint16_t* bank_a;  // arrange_tc_bank(w_ana, "analysis"): [half][n_ka][32][4*NN]
  const uint16_t* bank_s;  // arrange_tc_bank(w_syn, "synthesis"): [half][n_ks][32][4*NN]
  float* out;
  int B, Tx, M;
  int T_ana, T_out;
  int pad_a, pad_s;        // the analysis input's and the sub-bands' left pads
  int n_ka, n_ks, Tt, n_sub, WL, SL, WKa, WKs, stage;
  int swz;                 // the split window's swizzle (0: none)
};

// One phase of K3t: groups of MT m16 row tiles of A[t, q] = a[S*t + q]
// (halves ah, al) times the block's channel block of the arranged bank
// over n_k k-steps, split over WK warps; done(grp, acc) gets each item's
// full sum.  Where every item has a warp of its own (items * WK <= warps),
// the block meets in a barrier before the sums are done (with `sync`, or
// to add the slices); else each warp walks its items and finishes each at
// once.
template <int P, int NN, int MT, int LD, typename Done>
__device__ __forceinline__ void rt_phase(const uint16_t* ah,
                                         const uint16_t* al, int S, int swz,
                                         const uint16_t* bank, int plane,
                                         int n_k, int groups, int WK,
                                         float* red, bool sync, Done done) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int items = groups;
  float acc[MT][NN][4];
  auto zero = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nn][j] = 0.0f;
  };
  if (items * WK > kRtTcWarps) {  // WK == 1: a warp walks its items
    for (int it = warp; it < items; it += kRtTcWarps) {
      zero();
      tc_mma<P, NN, MT, LD>(acc, ah, al, S, swz, 16 * MT * it, bank, plane,
                            0, n_k);
      done(it, acc);
    }
    return;
  }
  const int it = warp % items;
  const int wk = warp / items;
  const bool on = warp < items * WK;
  constexpr int V = MT * NN * 4;  // sums a lane holds
  float* rp = red + it * V * 32 + lane;
  zero();
  if (on) {
    tc_mma<P, NN, MT, LD>(acc, ah, al, S, swz, 16 * MT * it, bank, plane,
                          n_k * wk / WK, n_k * (wk + 1) / WK);
    if (wk > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nn = 0; nn < NN; ++nn)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rp[((wk - 1) * items * V + (mt * NN + nn) * 4 + j) * 32] =
                acc[mt][nn][j];
    }
  }
  if (sync || WK > 1) __syncthreads();
  if (!on || wk > 0) return;
  for (int s = 1; s < WK; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[mt][nn][j] += rp[((s - 1) * items * V + (mt * NN + nn) * 4 + j) * 32];
  done(it, acc);
}

// C blocks a cluster (1: none).  At C > 1 (M = 32, 64) it replaces
// pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv (:794;
// _fused_roundtrip_single :715, pallas_call :751) there; bound by bytes
// (the shared-memory reads of A fragments, the bank), it splits the banks
// over the cluster so each block's slice stays resident (top of file).
// Block rank rho computes output channels c0 = 8 NN rho .. c0 + 8 NN - 1
// of the cluster's tiles.
template <int P, int NN, int MT, int LD, int C>
__global__ void __launch_bounds__(kRtTcThreads, kRtTcMinBlocks)
roundtrip_tc_kernel(const RtTcArgs a) {
  extern __shared__ float4 rt_tc_smem[];
  const int M = a.M;
  // bank elements of one half (of the block's channels); a staged bank
  // keeps the arranged layout, so its lo half is one chunk on either way
  const int chunk_a = a.n_ka * 128 * NN;
  const int chunk_s = a.n_ks * 128 * NN;
  constexpr int H = C > 1 && P == 1 ? 1 : 2;  // halves a staged bank takes
  uint16_t* bank_sm = reinterpret_cast<uint16_t*>(rt_tc_smem);
  float* raw = reinterpret_cast<float*>(
      bank_sm + (a.stage ? H * (chunk_a + chunk_s) : 0));
  uint16_t* xh = reinterpret_cast<uint16_t*>(raw + a.WL);
  uint16_t* xl = xh + a.WL;
  // the split sub-band tile, in the split window's place where the
  // analysis is one item a warp (the window is read by then)
  uint16_t* sh = a.SL ? xl + a.WL : xh;
  uint16_t* sl = a.SL ? sh + a.SL : xl;
  float* red = reinterpret_cast<float*>(a.SL ? sl + a.SL : xl + a.WL);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int tiles_x = cdiv(a.T_out, a.Tt);
  const int n_tiles = a.B * tiles_x;
  const int r = 16 * MT;  // rows of a warp item
  const int rank = C > 1 ? blockIdx.x % C : 0;
  const int c0 = 8 * NN * rank;  // the block's first output channel
  const int tile0 = C > 1 ? blockIdx.x / C : blockIdx.x;
  const int tile_step = C > 1 ? gridDim.x / C : gridDim.x;

  // both arranged banks, both halves, as they are; in a cluster this
  // block's channels of them: NN = 2 its channel block rho (16 bytes a
  // lane a k-step), NN = 1 its n8 tile (channel block rho / 2, words
  // 4 (rho % 2) .. +3 of a lane's 8: 8 bytes)
  const uint16_t* ba = a.bank_a;
  const uint16_t* bs = a.bank_s;
  if (C > 1) {
    const int n_cb = cdiv(M, 16);
    const int cb = NN == 2 ? rank : rank >> 1;
    const int w0 = NN == 2 ? 0 : 4 * (rank & 1);
    for (int h = 0; h < H; ++h) {
      const long long src_a = ((long long)(h * n_cb + cb) * a.n_ka) * 256;
      const long long src_s = ((long long)(h * n_cb + cb) * a.n_ks) * 256;
#pragma unroll 4
      for (int i = tid; i < a.n_ka * 32; i += kRtTcThreads) {
        if (NN == 2)
          cp_async16(bank_sm + h * chunk_a + 8 * i, a.bank_a + src_a + 8 * i,
                     16);
        else
          cp_async8(bank_sm + h * chunk_a + 4 * i,
                    a.bank_a + src_a + 8 * i + w0);
      }
#pragma unroll 4
      for (int i = tid; i < a.n_ks * 32; i += kRtTcThreads) {
        if (NN == 2)
          cp_async16(bank_sm + H * chunk_a + h * chunk_s + 8 * i,
                     a.bank_s + src_s + 8 * i, 16);
        else
          cp_async8(bank_sm + H * chunk_a + h * chunk_s + 4 * i,
                    a.bank_s + src_s + 8 * i + w0);
      }
    }
    ba = bank_sm;
    bs = bank_sm + H * chunk_a;
  } else if (a.stage) {
    for (int h = 0; h < (P == 3 ? 2 : 1); ++h) {
#pragma unroll 4
      for (int i = tid; i < chunk_a / 8; i += kRtTcThreads)
        cp_async16(bank_sm + h * chunk_a + 8 * i, a.bank_a + h * chunk_a + 8 * i,
                   16);
#pragma unroll 4
      for (int i = tid; i < chunk_s / 8; i += kRtTcThreads)
        cp_async16(bank_sm + 2 * chunk_a + h * chunk_s + 8 * i,
                   a.bank_s + h * chunk_s + 8 * i, 16);
    }
    ba = bank_sm;
    bs = bank_sm + 2 * chunk_a;
  }

  // the raw window of tile `tl`: the signal from M*(t0 - pad_s) - pad_a on,
  // zeros outside it (the analysis pad, and past the end)
  auto copy_window = [&](int tl) {
    const int b = tl / tiles_x;
    const int t0 = (tl - b * tiles_x) * a.Tt;
    const long long p0 = (long long)(t0 - a.pad_s) * M - a.pad_a;
    const float* xb = a.x + (long long)b * a.Tx;
    if ((p0 & 3) == 0 && (a.Tx & 3) == 0 &&
        ((unsigned long long)a.x & 15) == 0) {
#pragma unroll 4
      for (int i = tid; i < a.WL / 4; i += kRtTcThreads) {
        const long long p = p0 + 4 * i;
        const bool in = p >= 0 && p < a.Tx;
        cp_async16(raw + 4 * i, in ? xb + p : a.x, in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < a.WL; i += kRtTcThreads) {
        const long long p = p0 + i;
        const bool in = p >= 0 && p < a.Tx;
        cp_async4(raw + i, in ? xb + p : a.x, in ? 4 : 0);
      }
    }
  };

  if (tile0 < n_tiles) copy_window(tile0);
  cp_async_commit();

  bool first = true;
  for (int tile = tile0; tile < n_tiles; tile += tile_step) {
    const int b = tile / tiles_x;
    const int t0 = (tile - b * tiles_x) * a.Tt;
    const int tau0 = t0 - a.pad_s;  // sub-band time of tile row 0
    const int n_out = min(a.Tt, a.T_out - t0);
    cp_async_wait_all();
    __syncthreads();  // the raw window (and the banks) are in; the last
                      // tile's reads of the sub-band tile are done
    if (C > 1 && !first) cluster_wait();  // the peers have read our chunks
    first = false;
    for (int i = 2 * tid; i < a.WL; i += 2 * kRtTcThreads) {
      const float2 v = *reinterpret_cast<const float2*>(raw + i);
      put_split2<P>(xh, xl, 8 * swizzle(i >> 3, a.swz) + (i & 7), v.x, v.y);
    }
    __syncthreads();
    if (tile + tile_step < n_tiles) copy_window(tile + tile_step);
    cp_async_commit();

    // analysis: every sub-band row of the tile, split again into the
    // sub-band tile; the synthesis pad and the sub-bands' end are zeros
    rt_phase<P, NN, MT, LD>(
        xh, xl, M, a.swz, ba, chunk_a, a.n_ka, a.n_sub / r, a.WKa, red,
        a.SL == 0, [&](int grp, const float (&acc)[MT][NN][4]) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nn = 0; nn < NN; ++nn)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int s = r * grp + 16 * mt + g + 8 * h;
                const int c = c0 + nn * 8 + 2 * tq;
                const bool in = tau0 + s >= 0 && tau0 + s < a.T_ana;
                if (c < M) {
                  const int i = s * M + c;
                  put_split2<P>(sh, sl, 8 * swizzle(i >> 3, a.swz) + (i & 7),
                                in ? acc[mt][nn][2 * h] : 0.0f,
                                in ? acc[mt][nn][2 * h + 1] : 0.0f);
                }
              }
        });
    if (C > 1) {
      cluster_arrive();
      cluster_wait();  // every block's chunks are in its tile
      // the other blocks' 16-byte chunks (row s, channels 8k .. 8k+7 come
      // from block k / NN), each at its swizzled place in both tiles
      for (int u = tid; u < a.n_sub * C * NN; u += kRtTcThreads) {
        const int owner = (u & (C * NN - 1)) / NN;
        if (owner == rank) continue;
        const int o = 8 * swizzle(u, a.swz);
        *reinterpret_cast<uint4*>(sh + o) =
            *reinterpret_cast<const uint4*>(cluster_ptr(sh + o, owner));
        if (P == 3)
          *reinterpret_cast<uint4*>(sl + o) =
              *reinterpret_cast<const uint4*>(cluster_ptr(sl + o, owner));
      }
      cluster_arrive();  // done reading the peers' chunks
    }
    __syncthreads();

    // synthesis: the output steps of the tile, gain M
    const float gain = (float)M;
    rt_phase<P, NN, MT, LD>(
        sh, sl, M, a.swz, bs, chunk_s, a.n_ks, a.Tt / r, a.WKs, red, false,
        [&](int grp, const float (&acc)[MT][NN][4]) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nn = 0; nn < NN; ++nn)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int t = r * grp + 16 * mt + g + 8 * h;
                const int c = c0 + nn * 8 + 2 * tq;
                if (t < n_out && c < M)
                  *reinterpret_cast<float2*>(
                      a.out + ((long long)b * a.T_out + t0 + t) * M + c) =
                      make_float2(gain * acc[mt][nn][2 * h],
                                  gain * acc[mt][nn][2 * h + 1]);
              }
        });
  }
  if (C > 1 && !first) cluster_wait();  // no block exits while a peer reads
  cp_async_wait_all();                   // no copy outlives the block
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// log2(n) where n is a power of two, else -1
int log2_exact(int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  return (1 << lg) == n ? lg : -1;
}

// the instance of K1t (KIND 1) / K2t (KIND 2) for (passes, n8 tiles,
// m16 tiles a warp, fragment loads), or nullptr for other passes
using TcKernel = void (*)(const TcArgs);

template <int P, int NN, int MT, int KIND>
TcKernel tc_pick_ld(int LD) {
  return LD == 0   ? conv_tc_kernel<P, NN, MT, 0, KIND>
         : LD == 1 ? conv_tc_kernel<P, NN, MT, 1, KIND>
                   : conv_tc_kernel<P, NN, MT, 2, KIND>;
}

template <int P, int KIND>
TcKernel tc_pick_p(int NN, int MT, int LD) {
  if (NN == 2)
    return MT == 2 ? tc_pick_ld<P, 2, 2, KIND>(LD) : tc_pick_ld<P, 2, 1, KIND>(LD);
  return MT == 2 ? tc_pick_ld<P, 1, 2, KIND>(LD) : tc_pick_ld<P, 1, 1, KIND>(LD);
}

template <int KIND>
TcKernel tc_pick(int passes, int NN, int MT, int LD) {
  if (passes == 3) return tc_pick_p<3, KIND>(NN, MT, LD);
  if (passes == 1) return tc_pick_p<1, KIND>(NN, MT, LD);
  return nullptr;
}

// launch K1t / K2t: a.x, bank, out, B, Tx, N, T_out, pad_left, fuse_mask
// and x_offset set by the caller; the geometry and the plan here
template <int KIND>
int tc_launch(TcArgs a, int S, int Q, int passes, void* stream) {
  const TcGeom g = tc_geom(KIND, S, Q, a.N);
  if (tc_smem_gate(g) > kSmemLimit) return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = tc_plan(g, a.B, a.T_out, n_sms);
  const int WK = p.aux;
  const int MT = p.tile_steps * WK / (16 * kTcWarps);
  const TcWin w = tc_win(g, p.tile_steps);
  const int LD = S % 8 == 0 ? 0 : S % 2 == 0 ? 1 : 2;
  const TcKernel kernel = tc_pick<KIND>(passes, g.NN, MT, LD);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  a.S = S;
  a.lgS = log2_exact(S);
  a.n_k = g.n_k;
  a.n_cb = g.n_cb;
  a.WK = WK;
  a.nT = w.nT;
  a.WL = w.WL;
  a.XR = w.XR;
  a.raw = w.raw;
  a.stage = p.stage ? 1 : 0;
  a.swz = LD == 0 && log2_exact(S) >= 3 ? min_i(S / 8, 8) - 1 : 0;
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.gx, p.gy, p.gz), p.threads, p.smem,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the instance of K3t for (passes, n8 tiles, m16 tiles an item, fragment
// loads, blocks a cluster), or nullptr for other passes
using RtTcKernel = void (*)(const RtTcArgs);

template <int P>
RtTcKernel rt_tc_pick_p(int NN, int MT, int LD, int C) {
  if (C > 1 && NN == 1) {
    if (C == 8)
      return MT == 2 ? roundtrip_tc_kernel<P, 1, 2, 0, 8> : roundtrip_tc_kernel<P, 1, 1, 0, 8>;
    return MT == 2 ? roundtrip_tc_kernel<P, 1, 2, 0, 4> : roundtrip_tc_kernel<P, 1, 1, 0, 4>;
  }
  if (C > 1) {
    if (C == 4)
      return MT == 2 ? roundtrip_tc_kernel<P, 2, 2, 0, 4> : roundtrip_tc_kernel<P, 2, 1, 0, 4>;
    return MT == 2 ? roundtrip_tc_kernel<P, 2, 2, 0, 2> : roundtrip_tc_kernel<P, 2, 1, 0, 2>;
  }
  if (NN == 2)
    return MT == 2 ? roundtrip_tc_kernel<P, 2, 2, 0, 1> : roundtrip_tc_kernel<P, 2, 1, 0, 1>;
  if (LD == 0)
    return MT == 2 ? roundtrip_tc_kernel<P, 1, 2, 0, 1> : roundtrip_tc_kernel<P, 1, 1, 0, 1>;
  return MT == 2 ? roundtrip_tc_kernel<P, 1, 2, 1, 1> : roundtrip_tc_kernel<P, 1, 1, 1, 1>;
}

RtTcKernel rt_tc_pick(int passes, int NN, int MT, int LD, int C) {
  if (C != 1 && !(NN == 1 && (C == 4 || C == 8)) &&
      !(NN == 2 && (C == 2 || C == 4)))
    return nullptr;
  if (passes == 3) return rt_tc_pick_p<3>(NN, MT, LD, C);
  if (passes == 1) return rt_tc_pick_p<1>(NN, MT, LD, C);
  return nullptr;
}

// a launch of K3t in clusters of C blocks
cudaLaunchConfig_t rt_tc_config(const Plan& p, int C, int blocks,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of K3t's whole-file tile (M >= 32) the card holds at once
cudaError_t rt_tc_max_clusters(const RtTcGeom& g, int passes,
                               int* clusters) {
  *clusters = 0;
  const int Tt = rt_tc_persist_steps(g);
  const RtTcTile t = rt_tc_tile(g, Tt, true);
  const RtTcKernel kernel = rt_tc_pick(passes, g.bNN, t.MT, 0, g.C);
  if (kernel == nullptr || g.C < 2) return cudaErrorInvalidValue;
  Plan p = {};
  p.threads = kRtTcThreads;
  p.smem = (size_t)(g.bank_bytes + t.rest);
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = rt_tc_config(p, g.C, g.C, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace

extern "C" {

// Shared memory one block of tier kernel `which` (1 K1t, 2 K2t, 3 K3t)
// may use at `passes` (K1t/K2t: the most of any of their plans; K3t from
// M = 32 stages one half at passes 1); the Python gates mirror this and
// check against it.
size_t pqmf_tc_smem_bytes(int which, int M, int Mb, int Ka, int Ks,
                          int passes) {
  switch (which) {
    case 1: return (size_t)tc_smem_gate(tc_geom(1, M, Ka, Mb));
    case 2: return (size_t)tc_smem_gate(tc_geom(2, Mb, Mb * Ks, M));
    case 3: return (size_t)rt_tc_smem_gate(rt_tc_geom(M, Ka, Ks, passes));
    default: return 0;
  }
}

// The launch plan of tier kernel `which` at `passes`, in pqmf_launch_plan's
// layout: plan[5] is K1t/K2t's reduction split WK (K3t's sub-band steps a
// tile), plan[6] their output channels a block (K3t: its blocks a cluster,
// 1 up to M = 16); max_clusters as pqmf_launch_plan's (K3t from M = 32:
// pqmf_tc_rt_max_clusters).
int pqmf_tc_launch_plan(int which, int B, int M, int Mb, int Ka, int Ks,
                        int T_out, int n_sms, int passes, int max_clusters,
                        long long* plan) {
  Plan p;
  switch (which) {
    case 1: p = tc_plan(tc_geom(1, M, Ka, Mb), B, T_out, n_sms); break;
    case 2: p = tc_plan(tc_geom(2, Mb, Mb * Ks, M), B, T_out, n_sms); break;
    case 3:
      p = rt_tc_plan(rt_tc_geom(M, Ka, Ks, passes), B, T_out, n_sms,
                     max_clusters);
      break;
    default: return -1;
  }
  const long long v[8] = {p.gx, p.gy, p.gz, p.threads, p.tile_steps, p.aux,
                          p.split, (long long)p.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

// The clusters of K3t's (M = 32, 64) whole-file tile at `passes` the card
// holds at once (cudaOccupancyMaxActiveClusters), into *clusters; returns
// a cudaError_t.
int pqmf_tc_rt_max_clusters(int M, int Ka, int Ks, int passes,
                            int* clusters) {
  const RtTcGeom g = rt_tc_geom(M, Ka, Ks, passes);
  *clusters = 0;
  if (!rt_tc_templated(M) || g.C < 2 || rt_tc_smem_gate(g) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return (int)rt_tc_max_clusters(g, passes, clusters);
}

// x: [B, 1, Tx], zero-padded by pad_left on the left and by zeros past Tx;
// bank: arrange_tc_bank(w, "analysis", tier) of w [Mb, 1, K]; passes 3
// ("bf16x3") or 1 ("default").
int pqmf_tc_analysis_conv(const float* x, const void* bank, float* out,
                          int B, int Tx, int M, int Mb, int K, int T_out,
                          int pad_left, int fuse_mask, int passes,
                          void* stream) {
  TcArgs a = {};
  a.x = x;
  a.bank = static_cast<const uint16_t*>(bank);
  a.out = out;
  a.B = B;
  a.Tx = Tx;
  a.N = Mb;
  a.T_out = T_out;
  a.pad_left = pad_left;
  a.fuse_mask = fuse_mask;
  return tc_launch<1>(a, M, K, passes, stream);
}

// x: [B, Mb, Tx], zero-padded by pad_left on the left and by zeros past Tx;
// x_offset is the position of x[..., 0] in the signal whose parity the
// sign mask counts; bank: arrange_tc_bank(w, "synthesis", tier) of w
// [M, Mb, K].  Output [B, T_out, M].
int pqmf_tc_synthesis_conv(const float* x, const void* bank, float* out,
                           int B, int Mb, int Tx, int M, int K, int T_out,
                           int pad_left, int fuse_mask, int x_offset,
                           int passes, void* stream) {
  TcArgs a = {};
  a.x = x;
  a.bank = static_cast<const uint16_t*>(bank);
  a.out = out;
  a.B = B;
  a.Tx = Tx;
  a.N = M;
  a.T_out = T_out;
  a.pad_left = pad_left;
  a.fuse_mask = fuse_mask;
  a.x_offset = x_offset;
  return tc_launch<2>(a, Mb, Mb * K, passes, stream);
}

// x: [B, 1, Tx], zero-padded by pad_a on the left and by zeros past Tx;
// bank_a / bank_s: arrange_tc_bank(w_ana, "analysis", tier) of w_ana
// [M, 1, Ka] and arrange_tc_bank(w_syn, "synthesis", tier) of w_syn
// [M, M, Ks]; the sub-bands (T_ana steps) zero-padded by pad_s on the left
// and by zeros past T_ana.  Output [B, T_out, M].
int pqmf_tc_roundtrip_conv(const float* x, const void* bank_a,
                           const void* bank_s, float* out, int B, int Tx,
                           int M, int Ka, int Ks, int T_ana, int T_out,
                           int pad_a, int pad_s, int passes, void* stream) {
  const RtTcGeom g = rt_tc_geom(M, Ka, Ks, passes);
  if (!rt_tc_templated(M) || rt_tc_smem_gate(g) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  bool persist = false;
  const RtTcTile t = rt_tc_choice(g, B, T_out, n_sms, &persist);
  int clusters = 0;
  if (persist && g.C > 1) {  // as many clusters as the card holds, or none
    err = rt_tc_max_clusters(g, passes, &clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const Plan p = rt_tc_plan(g, B, T_out, n_sms, clusters);
  const int LD = M % 8 == 0 ? 0 : 1;
  const RtTcKernel kernel = rt_tc_pick(passes, g.bNN, t.MT, LD, g.C);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  RtTcArgs a = {};
  a.x = x;
  a.bank_a = static_cast<const uint16_t*>(bank_a);
  a.bank_s = static_cast<const uint16_t*>(bank_s);
  a.out = out;
  a.B = B;
  a.Tx = Tx;
  a.M = M;
  a.T_ana = T_ana;
  a.T_out = T_out;
  a.pad_a = pad_a;
  a.pad_s = pad_s;
  a.n_ka = g.n_ka;
  a.n_ks = g.n_ks;
  a.Tt = t.Tt;
  a.n_sub = t.n_sub;
  a.WL = t.WL;
  a.SL = t.SL;
  a.WKa = t.WKa;
  a.WKs = t.WKs;
  a.stage = p.stage ? 1 : 0;
  a.swz = LD == 0 ? min_i(M / 8, 8) - 1 : 0;
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (g.C > 1) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        rt_tc_config(p, g.C, p.gx, (cudaStream_t)stream, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<p.gx, p.threads, p.smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
