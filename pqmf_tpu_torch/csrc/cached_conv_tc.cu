// Hand-written Hopper (sm_90a) tensor-core kernels for the "bf16x3" and
// "default" precision tiers of the PQMF streaming path's three
// convolutions.  Plain C interface, built with nvcc beside cached_conv.cu
// into one library and loaded with ctypes (pqmf_tpu_torch/kernels/_build.py);
// the Python wrappers, their plain versions and a mirror of every launch
// plan live in pqmf_tpu_torch/kernels/cached_conv.py.
//
// K1t analysis  replaces pqmf_tpu/kernels/cached_conv.py:strided_analysis_conv
//   at mxu_precision "bf16x3" / "default" (_prec_dot, :93)
// K2t synthesis replaces pqmf_tpu/kernels/cached_conv.py:dense_synthesis_conv
//   at those tiers (_slice_dots, :207)
// K3t roundtrip replaces pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv
//   at those tiers (_fused_rt_kernel, :632: the f32 mid is split again)
//
// The tiers: every f32 operand is split once, as it is staged in shared
// memory, into hi = bf16(a) and lo = bf16(a - hi), both rounded to nearest
// even (JAX's _split_bf16 with _SPLIT_WINDOW_ONCE).  "bf16x3" sums hi*hi +
// hi*lo + lo*hi, "default" hi*hi, with f32 accumulators, on the tensor
// cores (mma.sync m16n8k16 bf16 -> f32): PASSES = 3 or 1.
//
// Each convolution is a GEMM whose A operand is a strided Hankel matrix of
// one buffer in shared memory, A[t, q] = buf[S*t + q]:
// - K1t: buf is the padded signal from M*t0 on, S = M, q < K, and
//   B[q, c] = w[c, 0, q]; the sign mask goes on the output.
// - K2t: buf is the sub-band window staged time-major, win[tau][m], with the
//   input sign mask applied as it is staged; S = Mb, q = k*Mb + m, and
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
// call is HBM-bound at "default" and near the line at "bf16x3".  These
// kernels are the simple form: each warp loads its A and B fragments from
// shared memory with 32-bit loads (16 loads per k-step for 6 mma at
// "bf16x3", two n8 tiles sharing A), so shared-memory bandwidth bounds
// them below mma.sync's peak; wgmma and TMA are later work.  K1t and K2t
// stage their bank chunk once per block and walk tiles of 64 output steps
// (one m16 tile a warp) with a stride of the grid; a bank too large for the
// block is staged in chunks of the reduction, per tile.  K3t stages both
// banks once and walks tiles of 224 output steps (256 sub-band steps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTcThreads = 128;                // K1t/K2t: threads a block
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcRows = 16 * kTcWarps;         // K1t/K2t: output steps a tile
constexpr long long kTcBankBytes = 72 * 1024;  // cap on a staged bank chunk
constexpr int kRtTcThreads = 256;              // K3t: threads a block
constexpr int kRtTcWarps = kRtTcThreads / 32;
constexpr int kRtTcOut = 224;                  // K3t: output steps a tile
// blocks an SM the register allocation plans for: without them ptxas kept
// K1t and K3t at 48 registers and spilled one (4 bytes) where the shared
// memory holds 5 K1t/K2t blocks and 2 K3t blocks an SM anyway
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
inline int min_i(int a, int b) { return a < b ? a : b; }
inline int max_i(int a, int b) { return a > b ? a : b; }

// A launch, in the layout of cached_conv.cu's Plan: grid, threads, output
// steps a tile, K1t/K2t's reduction chunk (K3t's sub-band steps a tile),
// K1t/K2t's output channels a block (K3t: 1), dynamic shared memory.
struct Plan {
  int gx, gy, gz, threads, tile_steps, aux, split;
  size_t smem;
};

// K1t/K2t: a conv of stride S whose reduction runs over Q terms into N
// output channels.  CB channels a block (two n8 tiles from 16 on), `rows`
// of them staged; the reduction padded to Qp, staged in chunks of QC
// columns (rows QS = QC + 8 apart: 32-bit B loads hit 32 distinct banks);
// a window of WL elements.  Shared memory: hi and lo halves of both.
struct TcGeom {
  int Qp, CB, rows, QC, QS, WL;
  size_t smem;
};

TcGeom tc_geom(int S, int Q, int N) {
  TcGeom g;
  g.Qp = round16(Q);
  g.CB = N >= 16 ? 16 : 8;
  g.rows = min_i(g.CB, N);
  g.WL = round8(S * (kTcRows - 1 + cdiv(g.Qp, S)));
  long long budget = kSmemLimit - 4LL * g.WL;
  if (budget > kTcBankBytes) budget = kTcBankBytes;
  const long long qc = (budget / (4LL * g.rows) - 8) / 16 * 16;
  g.QC = (int)(qc < g.Qp ? qc : g.Qp);
  if (g.QC < 16) g.QC = 16;
  g.QS = g.QC + 8;
  g.smem = 4 * ((size_t)g.rows * g.QS + (size_t)g.WL);
  return g;
}

Plan tc_plan(int B, int S, int Q, int N, int T_out, int n_sms) {
  const TcGeom g = tc_geom(S, Q, N);
  Plan p;
  p.gy = cdiv(N, g.CB);
  p.gz = 1;
  p.threads = kTcThreads;
  p.tile_steps = kTcRows;
  p.aux = g.QC;
  p.split = g.CB;
  p.smem = g.smem;
  const int tiles = B * cdiv(T_out, kTcRows);
  const int per_sm = max_i(1, min_i(2048 / kTcThreads,
                                    (int)(kSmemPerSm / (g.smem + 1024))));
  p.gx = min_i(tiles, max_i(1, n_sms * per_sm / p.gy));
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
  return p;
}

// ---------------------------------------------------------------------------
// the split and the mma tile the three kernels share
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

// acc[n] += rows r0 .. r0+15 of A times B over n_k steps of 16, where
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
// K1t: strided analysis.  Block (tiles, band chunk): it stages its chunk of
// the bank and walks the tiles (batch row, 64 output steps) with a stride of
// the grid; warp w computes output steps 16w .. 16w+15 of the tile.
// ---------------------------------------------------------------------------
template <int P, int NN, bool EVEN>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
analysis_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int B, int Tx, int M, int Mb,
                   int K, int T_out, int pad_left, int fuse_mask, int QC,
                   int QS, int WL) {
  extern __shared__ float4 ana_tc_smem[];
  constexpr int CB = 8 * NN;
  const int rows = Mb < CB ? Mb : CB;
  uint16_t* wh = reinterpret_cast<uint16_t*>(ana_tc_smem);  // [rows][QS]
  uint16_t* wl = wh + rows * QS;
  uint16_t* xh = wl + rows * QS;  // [WL] = xpad[M*t0 + i]
  uint16_t* xl = xh + WL;
  const int c0 = blockIdx.y * CB;
  const int nb = min(CB, Mb - c0);
  const int Qp = round16(K);
  const int n_qc = cdiv(Qp, QC);
  const int tiles_x = cdiv(T_out, kTcRows);
  const int n_tiles = B * tiles_x;
  const int warp = threadIdx.x >> 5;

  // columns q0 .. q0 + n of the chunk's bank, zero from K on
  auto stage_bank = [&](int q0) {
    const int n = min(QC, Qp - q0);
    #pragma unroll kStageUnroll
    for (int e = threadIdx.x; e < nb * n; e += kTcThreads) {
      const int r = e / n;
      const int q = q0 + e - r * n;
      put_split<P>(wh, wl, r * QS + q - q0,
                   q < K ? w[(long long)(c0 + r) * K + q] : 0.0f);
    }
  };
  if (n_qc == 1) stage_bank(0);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_x;
    const int t0 = (tile - b * tiles_x) * kTcRows;
    __syncthreads();  // the last tile's reads are done
    // the window with the zero pad (pad_left, and past the input); every
    // element a padded column reads is written
    const long long p0 = (long long)t0 * M - pad_left;
    const float* xb = x + (long long)b * Tx;
    #pragma unroll kStageUnroll
    for (int i = threadIdx.x; i < WL; i += kTcThreads) {
      const long long p = p0 + i;
      put_split<P>(xh, xl, i, (p >= 0 && p < Tx) ? xb[p] : 0.0f);
    }
    float acc[NN][4];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nn][j] = 0.0f;
    for (int qc = 0; qc < n_qc; ++qc) {
      if (n_qc > 1) {
        if (qc) __syncthreads();
        stage_bank(qc * QC);
      }
      __syncthreads();
      mma_tile<P, NN, EVEN>(acc, xh, xl, M, qc * QC, 16 * warp, wh, wl, QS,
                            nb,
                      min(QC, Qp - qc * QC) / 16);
    }
    // reverse_half on the output: -1 where the band is odd and t even
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 16 * warp + (lane >> 2) + 8 * (j >> 1);
        const int c = c0 + nn * 8 + 2 * (lane & 3) + (j & 1);
        if (t < T_out && c < Mb) {
          const float v = acc[nn][j];
          out[((long long)b * Mb + c) * T_out + t] =
              fuse_mask && (c & 1) && !(t & 1) ? -v : v;
        }
      }
  }
}

// ---------------------------------------------------------------------------
// K2t: dense synthesis, time-major output.  Block (tiles, phase chunk), as
// K1t; the window is staged time-major, win[tau][m], sign mask applied.
// ---------------------------------------------------------------------------
template <int P, int NN, bool EVEN>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
synthesis_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int B, int Mb, int Tpad, int M,
                    int K, int T_out, int fuse_mask, int x_offset, int QC,
                    int QS, int WL) {
  extern __shared__ float4 syn_tc_smem[];
  constexpr int CB = 8 * NN;
  const int rows = M < CB ? M : CB;
  uint16_t* wh = reinterpret_cast<uint16_t*>(syn_tc_smem);  // [rows][QS]
  uint16_t* wl = wh + rows * QS;
  uint16_t* xh = wl + rows * QS;  // [nT][Mb] = s(m, t0+tau) x[m][t0+tau]
  uint16_t* xl = xh + WL;
  const int c0 = blockIdx.y * CB;
  const int nb = min(CB, M - c0);
  const int Q = Mb * K;
  const int Qp = round16(Q);
  const int n_qc = cdiv(Qp, QC);
  const int nT = kTcRows - 1 + cdiv(Qp, Mb);  // window steps
  const int tiles_x = cdiv(T_out, kTcRows);
  const int n_tiles = B * tiles_x;
  const int warp = threadIdx.x >> 5;

  // B[q, r] = w[M-1-c0-r][m][k] at q = k*Mb + m, zero from Mb*K on; the
  // taps are read in w's own order (k fastest: coalesced), each written to
  // its column
  auto stage_bank = [&](int q0) {
    const int n = min(QC, Qp - q0);
    for (int e = threadIdx.x; e < nb * (Qp - Q); e += kTcThreads) {
      const int r = e / (Qp - Q);
      const int q = Q + e - r * (Qp - Q);
      if (q >= q0 && q < q0 + n) put_split<P>(wh, wl, r * QS + q - q0, 0.0f);
    }
        // one row at a time, unrolled 4 times: on an H100 at [1,16,544] a loop
    // over all rows' taps (two divisions a tap) measured 21.5 us, this one
    // 16.4, and 26.0 unrolled 8 times
    for (int r = 0; r < nb; ++r) {
      const float* src = w + (long long)(M - 1 - c0 - r) * Q;
#pragma unroll 4
      for (int f = threadIdx.x; f < Q; f += kTcThreads) {  // f = m*K + k
        // loaded whether or not its column is in the chunk, so that the
        // unrolled loads issue together
        const float v = src[f];
        const int m = f / K;
        const int q = (f - m * K) * Mb + m;
        if (q >= q0 && q < q0 + n) put_split<P>(wh, wl, r * QS + q - q0, v);
      }
    }
  };
  if (n_qc == 1) stage_bank(0);

  const float gain = (float)M;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_x;
    const int t0 = (tile - b * tiles_x) * kTcRows;
    __syncthreads();
    // reverse_half on the input by the sample's position in the unpadded
    // signal (& 1 keeps the parity right where it is negative); zeros past
    // the input
    const float* xb = x + (long long)b * Mb * Tpad;
    #pragma unroll kStageUnroll
    for (int e = threadIdx.x; e < Mb * nT; e += kTcThreads) {
      const int m = e / nT;
      const int tau = e - m * nT;
      const int t = t0 + tau;
      float v = t < Tpad ? xb[(long long)m * Tpad + t] : 0.0f;
      if (fuse_mask && (m & 1) && !((t + x_offset) & 1)) v = -v;
      put_split<P>(xh, xl, tau * Mb + m, v);
    }
    float acc[NN][4];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nn][j] = 0.0f;
    for (int qc = 0; qc < n_qc; ++qc) {
      if (n_qc > 1) {
        if (qc) __syncthreads();
        stage_bank(qc * QC);
      }
      __syncthreads();
      mma_tile<P, NN, EVEN>(acc, xh, xl, Mb, qc * QC, 16 * warp, wh, wl,
                            QS, nb,
                      min(QC, Qp - qc * QC) / 16);
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 16 * warp + (lane >> 2) + 8 * (j >> 1);
        const int c = c0 + nn * 8 + 2 * (lane & 3) + (j & 1);
        if (t < T_out && c < M)
          out[((long long)b * T_out + t) * M + c] = gain * acc[nn][j];
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

// the kernel instance of (passes, two n8 tiles or one, even stride), or
// nullptr for other passes
#define PQMF_TC_PICK(kernel, passes, wide, even)                          \
  ((passes) == 3                                                          \
       ? ((wide) ? ((even) ? kernel<3, 2, true> : kernel<3, 2, false>)    \
                 : ((even) ? kernel<3, 1, true> : kernel<3, 1, false>))   \
   : (passes) == 1                                                        \
       ? ((wide) ? ((even) ? kernel<1, 2, true> : kernel<1, 2, false>)    \
                 : ((even) ? kernel<1, 1, true> : kernel<1, 1, false>))   \
       : nullptr)
#define PQMF_RT_PICK(passes, wide)                                        \
  ((passes) == 3 ? ((wide) ? roundtrip_tc_kernel<3, 2>                    \
                           : roundtrip_tc_kernel<3, 1>)                   \
   : (passes) == 1 ? ((wide) ? roundtrip_tc_kernel<1, 2>                  \
                             : roundtrip_tc_kernel<1, 1>)                 \
                   : nullptr)

}  // namespace

extern "C" {

// Shared memory one block of tier kernel `which` (1 K1t, 2 K2t, 3 K3t)
// uses; the Python gates mirror this and check against it.
size_t pqmf_tc_smem_bytes(int which, int M, int Mb, int Ka, int Ks) {
  switch (which) {
    case 1: return tc_geom(M, Ka, Mb).smem;
    case 2: return tc_geom(Mb, Mb * Ks, M).smem;
    case 3: return rt_tc_geom(M, Ka, Ks).smem;
    default: return 0;
  }
}

// The launch plan of tier kernel `which`, in pqmf_launch_plan's layout:
// plan[5] is K1t/K2t's reduction chunk (K3t's sub-band steps a tile),
// plan[6] their output channels a block (K3t: 1).
int pqmf_tc_launch_plan(int which, int B, int M, int Mb, int Ka, int Ks,
                        int T_out, int n_sms, long long* plan) {
  Plan p;
  switch (which) {
    case 1: p = tc_plan(B, M, Ka, Mb, T_out, n_sms); break;
    case 2: p = tc_plan(B, Mb, Mb * Ks, M, T_out, n_sms); break;
    case 3: p = rt_tc_plan(B, M, Ka, Ks, T_out, n_sms); break;
    default: return -1;
  }
  const long long v[8] = {p.gx, p.gy, p.gz, p.threads, p.tile_steps, p.aux,
                          p.split, (long long)p.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

// x: [B, 1, Tx], zero-padded by pad_left on the left and by zeros past Tx;
// passes 3 ("bf16x3") or 1 ("default").
int pqmf_tc_analysis_conv(const float* x, const float* w, float* out, int B,
                          int Tx, int M, int Mb, int K, int T_out,
                          int pad_left, int fuse_mask, int passes,
                          void* stream) {
  const TcGeom g = tc_geom(M, K, Mb);
  auto kernel = PQMF_TC_PICK(analysis_tc_kernel, passes, g.CB == 16,
                             (M & 1) == 0);
  if (kernel == nullptr || (long long)g.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = tc_plan(B, M, K, Mb, T_out, n_sms);
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.gx, p.gy, p.gz), p.threads, p.smem,
           (cudaStream_t)stream>>>(x, w, out, B, Tx, M, Mb, K, T_out,
                                   pad_left, fuse_mask, g.QC, g.QS, g.WL);
  return (int)cudaGetLastError();
}

int pqmf_tc_synthesis_conv(const float* x, const float* w, float* out, int B,
                           int Mb, int Tpad, int M, int K, int T_out,
                           int fuse_mask, int x_offset, int passes,
                           void* stream) {
  const TcGeom g = tc_geom(Mb, Mb * K, M);
  auto kernel = PQMF_TC_PICK(synthesis_tc_kernel, passes, g.CB == 16,
                             (Mb & 1) == 0);
  if (kernel == nullptr || (long long)g.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = tc_plan(B, Mb, Mb * K, M, T_out, n_sms);
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.gx, p.gy, p.gz), p.threads, p.smem,
           (cudaStream_t)stream>>>(x, w, out, B, Mb, Tpad, M, K, T_out,
                                   fuse_mask, x_offset, g.QC, g.QS, g.WL);
  return (int)cudaGetLastError();
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
