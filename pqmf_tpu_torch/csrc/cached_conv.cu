// Hand-written Hopper (sm_90a) kernels for the PQMF streaming path's three
// convolutions.  Plain C interface, built with nvcc and loaded with ctypes
// (pqmf_tpu_torch/kernels/_build.py); the Python wrappers and their plain
// PyTorch versions live in pqmf_tpu_torch/kernels/cached_conv.py.
//
// Every kernel computes a VALID convolution in f32 of an input the caller has
// already padded, launches on the stream it is given and allocates nothing.
//
// K1 analysis   replaces pqmf_tpu/kernels/cached_conv.py:strided_analysis_conv
//   out[b,c,t] = sum_k w[c,0,k] * x[b,0,t*M+k]   (x -1 where c odd, t even)
// K2 synthesis  replaces pqmf_tpu/kernels/cached_conv.py:dense_synthesis_conv
//   out[b,t,c] = M * sum_{m,k} w[M-1-c,m,k] * s(m,t+k) * x[b,m,t+k]
// K3 roundtrip  replaces pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv
//   K2(pad(K1(x), pad_left), w_syn) with both sign masks, which cancel.
//
// What bounds them on the H100: all three are f32 FMA on the CUDA cores
// (the "highest" tier is full f32, so no tensor-core tier applies), at about
// 1 kFLOP per input sample for K1 and 1 kFLOP per output sample for K2 against
// 8 bytes of device memory each: arithmetic and shared-memory bandwidth, not
// HBM.  The design answers that with data reuse: each block stages its haloed
// input window and the bank (flipped and scaled by M for K2/K3, with the input
// sign applied while staging) in shared memory once, and each thread keeps
// kR outputs in registers so one weight load feeds kR FMAs.  Lanes of a warp
// run over output channels, and every staged bank row has an odd stride, so
// the weight reads hit 16+ distinct banks and the window reads broadcast.
// K3 keeps the sub-band intermediate in shared memory and recomputes the
// Ks-1 sample halo of its tile from the input instead of carrying state
// between blocks: blocks run in parallel, in no order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // threads per block, all three kernels
constexpr int kR = 4;           // outputs one thread keeps in registers
constexpr int kAnaGroups = 16;  // K1: kAnaGroups * kR = 64 output steps a block
constexpr int kSynGroups = 16;  // K2: 64 output steps a block
constexpr int kRtGroups = 32;   // K3: 128 output steps a block
constexpr int kWeightBytes = 64 * 1024;  // cap on the bank chunk K1/K2 stage
constexpr size_t kStaticSmem = 48 * 1024;

__host__ __device__ inline int odd(int n) { return n | 1; }

inline int min_i(int a, int b) { return a < b ? a : b; }
inline int max_i(int a, int b) { return a > b ? a : b; }

// K1 stages Cb output bands of the bank at a time (all of them when they fit).
inline int analysis_chunk(int Mb, int K) {
  return max_i(1, min_i(Mb, kWeightBytes / (4 * odd(K))));
}

// K2 stages Cc output phases of the bank at a time.
inline int synthesis_chunk(int M, int Mb, int K) {
  return max_i(1, min_i(M, kWeightBytes / (4 * odd(Mb * K))));
}

__host__ __device__ inline int roundtrip_sub_len(int Ks) {
  const int n_sub = kRtGroups * kR + Ks - 1;
  return (n_sub + kR - 1) / kR * kR;
}

size_t analysis_smem(int M, int Mb, int K) {
  const int Tt = kAnaGroups * kR;
  return sizeof(float) *
         ((size_t)analysis_chunk(Mb, K) * odd(K) + (size_t)(Tt - 1) * M + K);
}

size_t synthesis_smem(int M, int Mb, int K) {
  const int Tt = kSynGroups * kR;
  return sizeof(float) * ((size_t)synthesis_chunk(M, Mb, K) * odd(Mb * K) +
                          (size_t)Mb * (Tt + K - 1));
}

size_t roundtrip_smem(int M, int Ka, int Ks) {
  const int sub_len = roundtrip_sub_len(Ks);
  return sizeof(float) * ((size_t)M * odd(Ka) + (size_t)M * odd(M * Ks) +
                          (size_t)M * sub_len + (size_t)(sub_len - 1) * M + Ka);
}

// ---------------------------------------------------------------------------
// K1: strided analysis.  Block (time tile, band chunk, batch row).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
analysis_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int Tpad, int M, int Mb, int K,
                int T_out, int Cb, int fuse_mask) {
  extern __shared__ float smem[];
  const int Tt = kAnaGroups * kR;
  const int Kw = odd(K);
  float* w_s = smem;             // [Cb][Kw]
  float* x_s = smem + Cb * Kw;   // [(Tt - 1) * M + K]
  const int t0 = blockIdx.x * Tt;
  const int c0 = blockIdx.y * Cb;
  const int b = blockIdx.z;
  const int cb = min(Cb, Mb - c0);

  for (int i = threadIdx.x; i < cb * K; i += blockDim.x) {
    const int c = i / K;
    const int k = i - c * K;
    w_s[c * Kw + k] = w[(long long)(c0 + c) * K + k];
  }
  // outputs past T_out read zeros here and are never stored
  const float* xb = x + (long long)b * Tpad;
  const long long start = (long long)t0 * M;
  const int win = (Tt - 1) * M + K;
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const long long p = start + i;
    x_s[i] = p < Tpad ? xb[p] : 0.0f;
  }
  __syncthreads();

  for (int item = threadIdx.x; item < cb * kAnaGroups; item += blockDim.x) {
    const int c = item % cb;
    const int g = item / cb;  // this thread's steps: g + j * kAnaGroups
    const float* wr = w_s + c * Kw;
    const float* xr = x_s + g * M;
    float acc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wk = wr[k];
#pragma unroll
      for (int j = 0; j < kR; ++j)
        acc[j] = fmaf(wk, xr[j * kAnaGroups * M + k], acc[j]);
    }
    const int cg = c0 + c;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int t = t0 + g + j * kAnaGroups;
      if (t < T_out) {
        // reverse_half on the output: -1 where the band is odd, t even
        const bool flip = fuse_mask && (cg & 1) && !(t & 1);
        out[((long long)b * Mb + cg) * T_out + t] = flip ? -acc[j] : acc[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dense synthesis, time-major output.  Block (time tile, phase chunk,
// batch row).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
synthesis_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int Mb, int Tpad, int M, int K,
                 int T_out, int Cc, int fuse_mask, int x_offset) {
  extern __shared__ float smem[];
  const int Tt = kSynGroups * kR;
  const int Wl = Tt + K - 1;     // staged window of one band
  const int Sw = odd(Mb * K);    // stride of one output phase's bank
  float* w_s = smem;             // [Cc][Sw] = M * w[M-1-c][m][k]
  float* x_s = smem + Cc * Sw;   // [Mb][Wl], input sign applied
  const int t0 = blockIdx.x * Tt;
  const int c0 = blockIdx.y * Cc;
  const int b = blockIdx.z;
  const int cc = min(Cc, M - c0);
  const float gain = (float)M;
  const int MK = Mb * K;

  for (int i = threadIdx.x; i < cc * MK; i += blockDim.x) {
    const int c = i / MK;
    const int r = i - c * MK;
    w_s[c * Sw + r] = gain * w[(long long)(M - 1 - (c0 + c)) * MK + r];
  }
  const float* xb = x + (long long)b * Mb * Tpad;
  for (int i = threadIdx.x; i < Mb * Wl; i += blockDim.x) {
    const int m = i / Wl;
    const int tau = t0 + (i - m * Wl);
    float v = tau < Tpad ? xb[(long long)m * Tpad + tau] : 0.0f;
    // reverse_half on the input, by the sample's position in the unpadded
    // signal; & 1 keeps the parity right where that position is negative
    if (fuse_mask && (m & 1) && !((tau + x_offset) & 1)) v = -v;
    x_s[i] = v;
  }
  __syncthreads();

  for (int item = threadIdx.x; item < cc * kSynGroups; item += blockDim.x) {
    const int c = item % cc;
    const int g = item / cc;
    float acc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = 0.0f;
    for (int m = 0; m < Mb; ++m) {
      const float* wr = w_s + c * Sw + m * K;
      const float* xr = x_s + m * Wl + g;
      for (int k = 0; k < K; ++k) {
        const float wk = wr[k];
#pragma unroll
        for (int j = 0; j < kR; ++j)
          acc[j] = fmaf(wk, xr[j * kSynGroups + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int t = t0 + g + j * kSynGroups;
      if (t < T_out) out[((long long)b * T_out + t) * M + c0 + c] = acc[j];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: fused round trip.  Block (output time tile, batch row).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
roundtrip_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                 const float* __restrict__ ws, float* __restrict__ out,
                 int Tpad, int M, int Ka, int Ks, int T_ana, int T_out,
                 int pad_left) {
  extern __shared__ float smem[];
  const int Tt = kRtGroups * kR;
  const int sub_len = roundtrip_sub_len(Ks);
  const int SG = sub_len / kR;   // sub-band groups a thread item covers
  const int Kaw = odd(Ka);
  const int Sw = odd(M * Ks);
  float* wa_s = smem;                // [M][Kaw]
  float* ws_s = wa_s + M * Kaw;      // [M][Sw] = M * w_syn[M-1-c][m][k]
  float* sub_s = ws_s + M * Sw;      // [M][sub_len] sub-band tile + halo
  float* x_s = sub_s + M * sub_len;  // [(sub_len - 1) * M + Ka]
  const int t0 = blockIdx.x * Tt;
  const int b = blockIdx.y;
  const int tau0 = t0 - pad_left;    // sub-band time of sub_s[.][0]
  const float gain = (float)M;
  const int MK = M * Ks;

  for (int i = threadIdx.x; i < M * Ka; i += blockDim.x) {
    const int m = i / Ka;
    wa_s[m * Kaw + (i - m * Ka)] = wa[i];
  }
  for (int i = threadIdx.x; i < M * MK; i += blockDim.x) {
    const int c = i / MK;
    const int r = i - c * MK;
    ws_s[c * Sw + r] = gain * ws[(long long)(M - 1 - c) * MK + r];
  }
  const float* xb = x + (long long)b * Tpad;
  const long long start = (long long)tau0 * M;
  const int win = (sub_len - 1) * M + Ka;
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const long long p = start + i;
    x_s[i] = (p >= 0 && p < Tpad) ? xb[p] : 0.0f;
  }
  __syncthreads();

  // analysis of the tile and its halo; the synthesis pad and the sub-band
  // signal's end are zeros, as in the composition
  for (int item = threadIdx.x; item < M * SG; item += blockDim.x) {
    const int m = item % M;
    const int g = item / M;
    const float* wr = wa_s + m * Kaw;
    const float* xr = x_s + g * M;
    float acc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = 0.0f;
    for (int k = 0; k < Ka; ++k) {
      const float wk = wr[k];
#pragma unroll
      for (int j = 0; j < kR; ++j)
        acc[j] = fmaf(wk, xr[j * SG * M + k], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int s = g + j * SG;
      const int tau = tau0 + s;
      sub_s[m * sub_len + s] = (tau >= 0 && tau < T_ana) ? acc[j] : 0.0f;
    }
  }
  __syncthreads();

  for (int item = threadIdx.x; item < M * kRtGroups; item += blockDim.x) {
    const int c = item % M;
    const int g = item / M;
    float acc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = 0.0f;
    for (int m = 0; m < M; ++m) {
      const float* wr = ws_s + c * Sw + m * Ks;
      const float* xr = sub_s + m * sub_len + g;
      for (int k = 0; k < Ks; ++k) {
        const float wk = wr[k];
#pragma unroll
        for (int j = 0; j < kR; ++j)
          acc[j] = fmaf(wk, xr[j * kRtGroups + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int t = t0 + g + j * kRtGroups;
      if (t < T_out) out[((long long)b * T_out + t) * M + c] = acc[j];
    }
  }
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

}  // namespace

extern "C" {

// Shared memory one block of kernel `which` (1 analysis, 2 synthesis,
// 3 round trip) uses; the Python gates mirror this and check against it.
size_t pqmf_smem_bytes(int which, int M, int Mb, int Ka, int Ks) {
  switch (which) {
    case 1: return analysis_smem(M, Mb, Ka);
    case 2: return synthesis_smem(M, Mb, Ks);
    case 3: return roundtrip_smem(M, Ka, Ks);
    default: return 0;
  }
}

const char* pqmf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int pqmf_analysis_conv(const float* x, const float* w, float* out, int B,
                       int Tpad, int M, int Mb, int K, int T_out,
                       int fuse_mask, void* stream) {
  const size_t smem = analysis_smem(M, Mb, K);
  cudaError_t err = allow_smem(analysis_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int Tt = kAnaGroups * kR;
  const int Cb = analysis_chunk(Mb, K);
  const dim3 grid((T_out + Tt - 1) / Tt, (Mb + Cb - 1) / Cb, B);
  analysis_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, Tpad, M, Mb, K, T_out, Cb, fuse_mask);
  return (int)cudaGetLastError();
}

int pqmf_synthesis_conv(const float* x, const float* w, float* out, int B,
                        int Mb, int Tpad, int M, int K, int T_out,
                        int fuse_mask, int x_offset, void* stream) {
  const size_t smem = synthesis_smem(M, Mb, K);
  cudaError_t err = allow_smem(synthesis_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int Tt = kSynGroups * kR;
  const int Cc = synthesis_chunk(M, Mb, K);
  const dim3 grid((T_out + Tt - 1) / Tt, (M + Cc - 1) / Cc, B);
  synthesis_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, Mb, Tpad, M, K, T_out, Cc, fuse_mask, x_offset);
  return (int)cudaGetLastError();
}

int pqmf_roundtrip_conv(const float* x, const float* wa, const float* ws,
                        float* out, int B, int Tpad, int M, int Ka, int Ks,
                        int T_ana, int T_out, int pad_left, void* stream) {
  const size_t smem = roundtrip_smem(M, Ka, Ks);
  cudaError_t err = allow_smem(roundtrip_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int Tt = kRtGroups * kR;
  const dim3 grid((T_out + Tt - 1) / Tt, B);
  roundtrip_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, wa, ws, out, Tpad, M, Ka, Ks, T_ana, T_out, pad_left);
  return (int)cudaGetLastError();
}

}  // extern "C"
