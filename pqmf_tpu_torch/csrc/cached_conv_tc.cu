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
//   at those tiers (_fused_rt_kernel, :632: the f32 mid is split again)
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
// - K3t: K1t's GEMM writes its sub-band tile time-major, split, straight
//   from the accumulators into shared memory, where it is K2t's window; the
//   two sign masks cancel, so neither is applied.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTcThreads = 128;                // K1t/K2t: threads a block
constexpr int kTcWarps = kTcThreads / 32;
constexpr long long kTcBankBytes = 144 * 1024; // most arranged bank a block stages
constexpr int kTcFillWarps = 8;   // small calls: warps an SM should get
constexpr int kTcPersistM16 = 16; // whole files: from n_sms * 16 m16 tiles on
constexpr int kRtTcThreads = 256;              // K3t: threads a block
constexpr int kRtTcWarps = kRtTcThreads / 32;
constexpr int kRtTcOut = 224;                  // K3t: output steps a tile
// blocks an SM the register allocation plans for: without them ptxas kept
// K1t and K3t at 48 registers and spilled one (4 bytes)
constexpr int kTcMinBlocks = 4;
constexpr int kRtTcMinBlocks = 2;
// staging loops unrolled so that a thread has several global loads in
// flight (K1t at [1,1,8704] on an H100: 21.7 us unrolled once, 10.6 four
// times, 9.8 eight times)
constexpr int kStageUnroll = 8;
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

// K3t: n_sub sub-band steps a tile (analysis rows), Tt output steps of them
// (synthesis rows), both multiples of 16; both banks, the signal window
// and the split sub-band tile (+16 zeros for the padded columns).
struct RtTcGeom {
  int Qa, Qs, n_sub, Tt, WLa, WLs;
  size_t smem;
};

RtTcGeom rt_tc_geom(int M, int Ka, int Ks) {
  RtTcGeom g;
  g.Qa = round16(Ka);
  g.Qs = round16(M * Ks);
  g.n_sub = round16(kRtTcOut + Ks - 1);
  g.Tt = (g.n_sub - Ks + 1) / 16 * 16;
  g.WLa = round8(M * (g.n_sub - 1) + g.Qa);
  g.WLs = round8(M * g.n_sub + 16);
  g.smem = 4 * ((size_t)M * (g.Qa + 8) + (size_t)M * (g.Qs + 8) +
                (size_t)g.WLa + (size_t)g.WLs);
  return g;
}

bool rt_tc_templated(int M) {
  return M == 2 || M == 4 || M == 8 || M == 16;
}

Plan rt_tc_plan(int B, int M, int Ka, int Ks, int T_out, int n_sms) {
  const RtTcGeom g = rt_tc_geom(M, Ka, Ks);
  Plan p;
  const int n_tiles = B * cdiv(T_out, g.Tt);
  const int per_sm = max_i(1, min_i(2048 / kRtTcThreads,
                                    (int)(kSmemPerSm / (g.smem + 1024))));
  p.gx = min_i(n_tiles, n_sms * per_sm);
  p.gy = 1;
  p.gz = 1;
  p.threads = kRtTcThreads;
  p.tile_steps = g.Tt;
  p.aux = g.n_sub;
  p.split = 1;
  p.smem = g.smem;
  p.stage = false;
  return p;
}

// ---------------------------------------------------------------------------
// the split, the fragment loads and the mma the kernels share
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the halves of v at index i: hi (and lo at PASSES == 3), to nearest even;
// v - hi is exact in f32
template <int P>
__device__ __forceinline__ void put_split(uint16_t* h, uint16_t* l, int i,
                                          float v) {
  const uint16_t hb = bf16_bits(v);
  h[i] = hb;
  if (P == 3) l[i] = bf16_bits(v - __bfloat162float(__ushort_as_bfloat16(hb)));
}

// the halves of v0, v1 at the even index i, one 32-bit store each
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// K3t's fragment loads: acc[n] += rows r0 .. r0+15 of A times B over n_k steps of 16, where
// A[t, q] = a[as*t + aq0 + q] (halves ah, al) and B[q, n] = b[n*bs + q]
// (halves bh, bl) for the nb channels staged, zero past them.  The
// fragments follow PTX's m16n8k16 layout: lane (g, tq) = (lane/4, lane%4)
// holds A rows g and g+8 at columns 2tq, 2tq+1 and 2tq+8, 2tq+9, B column g
// at rows 2tq, 2tq+1 and 2tq+8, 2tq+9, and C rows g, g+8 at columns 2tq,
// 2tq+1.  P = 3: hi*hi + hi*lo + lo*hi; P = 1: hi*hi.  EVEN: the stride
// `as` is even, so an A pair is one 32-bit load (a runtime choice here
// made ptxas spill K1t's registers).
template <int P, int NN, bool EVEN>
__device__ __forceinline__ void mma_tile(float (&acc)[NN][4],
                                         const uint16_t* ah,
                                         const uint16_t* al, int as, int aq0,
                                         int r0, const uint16_t* bh,
                                         const uint16_t* bl, int bs, int nb,
                                         int n_k) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ao = as * (r0 + g) + aq0 + 2 * tq;
  const int ao8 = ao + 8 * as;
  int bo[NN];
  bool bv[NN];
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    bv[nn] = nn * 8 + g < nb;
    bo[nn] = (bv[nn] ? nn * 8 + g : 0) * bs + 2 * tq;
  }
  for (int ks = 0; ks < n_k; ++ks) {
    const int k = 16 * ks;
    uint32_t a_h[4], a_l[4];
    a_h[0] = ld_pair(ah + ao + k, EVEN);
    a_h[1] = ld_pair(ah + ao8 + k, EVEN);
    a_h[2] = ld_pair(ah + ao + k + 8, EVEN);
    a_h[3] = ld_pair(ah + ao8 + k + 8, EVEN);
    if (P == 3) {
      a_l[0] = ld_pair(al + ao + k, EVEN);
      a_l[1] = ld_pair(al + ao8 + k, EVEN);
      a_l[2] = ld_pair(al + ao + k + 8, EVEN);
      a_l[3] = ld_pair(al + ao8 + k + 8, EVEN);
    }
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      uint32_t bh0 = ld_pair(bh + bo[nn] + k, true);
      uint32_t bh1 = ld_pair(bh + bo[nn] + k + 8, true);
      if (!bv[nn]) bh0 = bh1 = 0;
      // the step's sum starts from zero and joins acc by f32 adds, rounded
      // to nearest: the tensor cores' f32 accumulation truncates, and
      // accumulating into acc itself cost one ulp of the running sum per
      // mma (4.7e-5 over K1t's 99 mma on outputs of ~5)
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (P == 3) {
        uint32_t bl0 = ld_pair(bl + bo[nn] + k, true);
        uint32_t bl1 = ld_pair(bl + bo[nn] + k + 8, true);
        if (!bv[nn]) bl0 = bl1 = 0;
        mma_bf16(t, a_h, bl0, bl1);
        mma_bf16(t, a_l, bh0, bh1);
      }
      mma_bf16(t, a_h, bh0, bh1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nn][j] += t[j];
    }
  }
}

// ---------------------------------------------------------------------------
// K3t: fused round trip.  Persistent blocks walk the tiles (batch row, Tt
// output steps); the warps share the analysis rows, then the synthesis
// rows, of a tile.
// ---------------------------------------------------------------------------
template <int P, int NN>
__global__ void __launch_bounds__(kRtTcThreads, kRtTcMinBlocks)
roundtrip_tc_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int B, int Tpad, int M, int Ka, int Ks, int T_ana,
                    int T_out, int pad_left, int n_sub, int Tt, int WLa,
                    int WLs) {
  extern __shared__ float4 rt_tc_smem[];
  const int Qa = round16(Ka);
  const int Qs = round16(M * Ks);
  const int QSa = Qa + 8;
  const int QSs = Qs + 8;
  uint16_t* wah = reinterpret_cast<uint16_t*>(rt_tc_smem);  // [M][QSa]
  uint16_t* wal = wah + M * QSa;
  uint16_t* wsh = wal + M * QSa;  // [M][QSs]: B[k*M + m, c] = ws[M-1-c][m][k]
  uint16_t* wsl = wsh + M * QSs;
  uint16_t* xh = wsl + M * QSs;   // [WLa] = x[M*tau0 + i]
  uint16_t* xl = xh + WLa;
  uint16_t* sh = xl + WLa;        // [n_sub][M] sub-band tile, + 16 zeros
  uint16_t* sl = sh + WLs;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  #pragma unroll kStageUnroll
  for (int e = tid; e < M * Qa; e += kRtTcThreads) {
    const int r = e / Qa;
    const int q = e - r * Qa;
    put_split<P>(wah, wal, r * QSa + q, q < Ka ? wa[r * Ka + q] : 0.0f);
  }
  // the synthesis bank in ws's own order (k fastest: coalesced reads),
  // each tap to its column k*M + m; zero past M*Ks
  #pragma unroll kStageUnroll
  for (int e = tid; e < M * M * Ks; e += kRtTcThreads) {
    const int r = e / (M * Ks);
    const int f = e - r * M * Ks;  // m*Ks + k
    const int m = f / Ks;
    put_split<P>(wsh, wsl, r * QSs + (f - m * Ks) * M + m,
                 ws[(M - 1 - r) * M * Ks + f]);
  }
  for (int e = tid; e < M * (Qs - M * Ks); e += kRtTcThreads) {
    const int r = e / (Qs - M * Ks);
    put_split<P>(wsh, wsl, r * QSs + M * Ks + e - r * (Qs - M * Ks), 0.0f);
  }
  for (int i = M * n_sub + tid; i < WLs; i += kRtTcThreads)
    put_split<P>(sh, sl, i, 0.0f);

  const int tiles_per_row = cdiv(T_out, Tt);
  const int n_tiles = B * tiles_per_row;
  const float gain = (float)M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile / tiles_per_row;
    const int t0 = (tile - row * tiles_per_row) * Tt;
    const int tau0 = t0 - pad_left;  // sub-band time of tile row 0
    const int n_out = min(Tt, T_out - t0);
    __syncthreads();  // the last tile's reads (and the banks) are done
    const long long p0 = (long long)tau0 * M;
    const float* xb = x + (long long)row * Tpad;
    #pragma unroll kStageUnroll
    for (int i = tid; i < WLa; i += kRtTcThreads) {
      const long long p = p0 + i;
      put_split<P>(xh, xl, i, (p >= 0 && p < Tpad) ? xb[p] : 0.0f);
    }
    __syncthreads();

    // analysis of every sub-band row of the tile; the synthesis pad and
    // the sub-band signal's end are zeros, as in the composition
    for (int mt = warp; mt < n_sub / 16; mt += kRtTcWarps) {
      float acc[NN][4];
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nn][j] = 0.0f;
      mma_tile<P, NN, true>(acc, xh, xl, M, 0, 16 * mt, wah, wal, QSa, M,
                            Qa / 16);
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 16 * mt + (lane >> 2) + 8 * (j >> 1);
          const int c = nn * 8 + 2 * (lane & 3) + (j & 1);
          if (c < M) {
            const int tau = tau0 + s;
            put_split<P>(sh, sl, s * M + c,
                         (tau >= 0 && tau < T_ana) ? acc[nn][j] : 0.0f);
          }
        }
    }
    __syncthreads();

    for (int mt = warp; 16 * mt < n_out; mt += kRtTcWarps) {
      float acc[NN][4];
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nn][j] = 0.0f;
      mma_tile<P, NN, true>(acc, sh, sl, M, 0, 16 * mt, wsh, wsl, QSs, M,
                            Qs / 16);
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 16 * mt + (lane >> 2) + 8 * (j >> 1);
          const int c = nn * 8 + 2 * (lane & 3) + (j & 1);
          if (t < n_out && c < M)
            out[((long long)row * T_out + t0 + t) * M + c] =
                gain * acc[nn][j];
        }
    }
  }
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

#define PQMF_RT_PICK(passes, wide)                                        \
  ((passes) == 3 ? ((wide) ? roundtrip_tc_kernel<3, 2>                    \
                           : roundtrip_tc_kernel<3, 1>)                   \
   : (passes) == 1 ? ((wide) ? roundtrip_tc_kernel<1, 2>                  \
                             : roundtrip_tc_kernel<1, 1>)                 \
                   : nullptr)

}  // namespace

extern "C" {

// Shared memory one block of tier kernel `which` (1 K1t, 2 K2t, 3 K3t)
// may use (K1t/K2t: the most of any of their plans); the Python gates
// mirror this and check against it.
size_t pqmf_tc_smem_bytes(int which, int M, int Mb, int Ka, int Ks) {
  switch (which) {
    case 1: return (size_t)tc_smem_gate(tc_geom(1, M, Ka, Mb));
    case 2: return (size_t)tc_smem_gate(tc_geom(2, Mb, Mb * Ks, M));
    case 3: return rt_tc_geom(M, Ka, Ks).smem;
    default: return 0;
  }
}

// The launch plan of tier kernel `which`, in pqmf_launch_plan's layout:
// plan[5] is K1t/K2t's reduction split WK (K3t's sub-band steps a tile),
// plan[6] their output channels a block (K3t: 1).
int pqmf_tc_launch_plan(int which, int B, int M, int Mb, int Ka, int Ks,
                        int T_out, int n_sms, long long* plan) {
  Plan p;
  switch (which) {
    case 1: p = tc_plan(tc_geom(1, M, Ka, Mb), B, T_out, n_sms); break;
    case 2: p = tc_plan(tc_geom(2, Mb, Mb * Ks, M), B, T_out, n_sms); break;
    case 3: p = rt_tc_plan(B, M, Ka, Ks, T_out, n_sms); break;
    default: return -1;
  }
  const long long v[8] = {p.gx, p.gy, p.gz, p.threads, p.tile_steps, p.aux,
                          p.split, (long long)p.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
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

int pqmf_tc_roundtrip_conv(const float* x, const float* wa, const float* ws,
                           float* out, int B, int Tpad, int M, int Ka, int Ks,
                           int T_ana, int T_out, int pad_left, int passes,
                           void* stream) {
  const RtTcGeom g = rt_tc_geom(M, Ka, Ks);
  auto kernel = PQMF_RT_PICK(passes, M > 8);
  if (!rt_tc_templated(M) || kernel == nullptr ||
      (long long)g.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = rt_tc_plan(B, M, Ka, Ks, T_out, n_sms);
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.gx, p.threads, p.smem, (cudaStream_t)stream>>>(
      x, wa, ws, out, B, Tpad, M, Ka, Ks, T_ana, T_out, pad_left, g.n_sub,
      g.Tt, g.WLa, g.WLs);
  return (int)cudaGetLastError();
}

}  // extern "C"
