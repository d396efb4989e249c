// Hand-written Hopper (sm_90a) kernels for the flagship pitch shifter's
// middle: everything between K1's sub-bands and K2's synthesis except the two
// DFT products, which stay matrix products (torch.matmul through
// ops.stft.dft_matmul, as the JAX package leaves them to XLA).  Plain C
// interface, built with nvcc and loaded with ctypes
// (pqmf_tpu_torch/kernels/_build.py); the Python wrappers, their plain
// PyTorch versions and the stretch plan live in
// pqmf_tpu_torch/kernels/middle.py.
//
// Per step, with sub [B, Mb, Tb] (K1's output), F = n_fft/2 + 1 bins and
// fo[m] output frames in band m:
//
//   pv_frame_kernel     sub -> frames [Mb*B, frames, n_fft]: band-major
//                       rows, right pad to n_fft, centre pad, Hann window
//   (STFT product)      frames @ [C | S] -> spec [Mb*B, frames, 2F]
//   pv_spectral_kernel  spec -> rows [sum_m B*fo[m], 2F]: scale, magphase,
//                       the per-band stretch (frame gather, phase rule),
//                       cos / sin, only the frames that exist
//   (ISTFT product)     rows @ [Ci ; Si] -> prod [sum_m B*fo[m], n_fft]
//   pv_resynth_kernel   prod -> shifted [B, Mb, Tb] and the new tail:
//                       scale, window, overlap-add, window-square division,
//                       centre fit, the 1-frame fallback, the linear
//                       resample to Tb and the crossfade
//
// They replace no Pallas kernel: the JAX package writes the middle as plain
// jnp code and XLA fuses it (pqmf_tpu/pipelines.py, _fused_band_pitchshift).
// Run op by op in PyTorch it was ~120 elementwise, gather and copy kernels,
// each writing a full [Mb, B, F, frames] f32 tensor to device memory and
// reading it back, and a batched inverse DFT of one 11-row product for each
// band and stream.
//
// What bounds them on the H100: each touches every element once, so they
// are bound by device memory (a few bytes of traffic for each of tens of
// FLOPs, transcendentals included) and, at one stream, by the launch.  Their
// design: one thread for each output element (frame), each (band, stream,
// bin) (spectral), each output sample (resynth); neighbouring threads on
// neighbouring addresses for every store, no intermediate written to device
// memory beyond the two products' operands, and the inverse DFT's operand
// written as ONE dense row-major matrix of the frames that exist, so the
// product is one large GEMM instead of thousands of 11-row ones and no
// padded frame is computed.
//
// Every element is the plain path's f32 arithmetic in the plain path's
// order, with explicitly rounded operations (no fused multiply-add where the
// plain path rounds twice) and the libdevice atan2f / sinf / cosf / sqrt
// that PyTorch's kernels call, so a rounding that decides a phase-rule
// branch falls as it does there.  The running phase of the "accumulate"
// rule is summed in frame order in double, as PyTorch's CPU cumsum sums it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

// The stretch plan's integer table, one row of kPlanCols a band
// (kernels/middle.py: Plan.table): output frames, the band's first row of
// the compact matrix for one stream (times B), the centre-fit span
// [lo, hi) of the overlap-add buffer, and the stretched length.
enum { kFo = 0, kRow = 1, kLo = 2, kHi = 3, kLen = 4, kPlanCols = 5 };

// PyTorch's f32 constants: math.pi and 2*math.pi rounded to float
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ long long global_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * blockDim.x;
}

// torch.remainder(x + pi, 2 pi) - pi for a positive divisor: fmod, then the
// sign fix of PyTorch's kernel (BinaryRemainderKernel.cu)
__device__ __forceinline__ float principal_angle(float x) {
  float r = fmodf(__fadd_rn(x, kPi), kTwoPi);
  if (r < 0.0f) r = __fadd_rn(r, kTwoPi);
  return __fsub_rn(r, kPi);
}

// ---------------------------------------------------------------------------
// pv_frame_kernel: frames[(m*B + b), f, n] = xpad[f*hop + n] * w[n], where
// xpad is band m of stream b right-padded to n_fft and centre-padded by
// n_fft/2 (zeros).  Four consecutive n a thread, one float4 store.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
pv_frame_kernel(const float* __restrict__ sub, const float* __restrict__ w,
                float* __restrict__ out, int B, int Mb, int Tb, int n_fft,
                int hop, int frames, long long quads) {
  const int half = n_fft / 2;
  for (long long q = global_index(); q < quads; q += grid_stride()) {
    const long long e = q * 4;
    const int n = (int)(e % n_fft);
    const long long fr = e / n_fft;
    const int f = (int)(fr % frames);
    const long long row = fr / frames;
    const int m = (int)(row / B), b = (int)(row % B);
    const float* x = sub + ((long long)b * Mb + m) * Tb;
    const int s0 = f * hop + n - half;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = s0 + c;
      v[c] = (s >= 0 && s < Tb) ? __fmul_rn(x[s], w[n + c]) : 0.0f;
    }
    *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// pv_spectral_kernel: one thread a (band m, stream b, bin k), over the band's
// output frames j in order.  spec row (m*B + b) holds [re | -im] of each
// frame unscaled (the STFT product as it stands); rows receive
// [re_s | im_s] of frame j at row B*row[m] + b*fo[m] + j.
// ---------------------------------------------------------------------------
template <bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
pv_spectral_kernel(const float* __restrict__ spec,
                   const float* __restrict__ rates,
                   const int* __restrict__ plan,
                   const float* __restrict__ omega,
                   float* __restrict__ rows, int B, int Mb, int F,
                   int frames, float scale, long long items) {
  const int W = 2 * F;
  for (long long it = global_index(); it < items; it += grid_stride()) {
    const int k = (int)(it % F);
    const long long mb = it / F;
    const int m = (int)(mb / B), b = (int)(mb % B);
    const int* p = plan + m * kPlanCols;
    const int fo = p[kFo];
    const long long row0 = (long long)B * p[kRow] + (long long)b * fo;
    const float rate = rates[m], om = omega[k];
    const float* s = spec + ((long long)m * B + b) * frames * W;

    // the magnitude and phase of the two frames a step reads, kept while
    // the next step reads them again (t0 and t1 never decrease)
    int ta = -1, tb = -1;
    float mag_a = 0.0f, ph_a = 0.0f, mag_b = 0.0f, ph_b = 0.0f;
    auto load = [&](int t, float& mag, float& ph) {
      const float re = __fmul_rn(s[(long long)t * W + k], scale);
      const float im = __fmul_rn(-s[(long long)t * W + F + k], scale);
      mag = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(re, re),
                                           __fmul_rn(im, im)), 1e-12f));
      ph = atan2f(im, re);
    };
    double acc = 0.0;
    float dp_prev = 0.0f;
    for (int j = 0; j < fo; ++j) {
      const float tp = __fmul_rn((float)j, rate);
      const int t0 = min(max((int)floorf(tp), 0), frames - 1);
      const int t1 = min(t0 + 1, frames - 1);
      const float a = __fsub_rn(tp, (float)t0);
      if (t0 != ta) {
        if (t0 == tb) {
          ta = tb; mag_a = mag_b; ph_a = ph_b;
        } else {
          ta = t0; load(t0, mag_a, ph_a);
        }
      }
      if (t1 != tb) {
        if (t1 == ta) {
          tb = ta; mag_b = mag_a; ph_b = ph_a;
        } else {
          tb = t1; load(t1, mag_b, ph_b);
        }
      }
      const float mag = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, a), mag_a),
                                  __fmul_rn(a, mag_b));
      const float dp = principal_angle(__fsub_rn(__fsub_rn(ph_b, ph_a), om));
      float phi;
      if (kAccumulate) {
        // the running phase: phi_0 = phase of frame t0(0), then each step
        // adds the previous step's wrapped advance plus omega
        acc = j == 0 ? (double)ph_a
                     : __dadd_rn(acc, (double)__fadd_rn(dp_prev, om));
        phi = (float)acc;
        dp_prev = dp;
      } else {
        phi = __fadd_rn(__fadd_rn(ph_a, om), __fmul_rn(a, dp));
      }
      float* r = rows + (row0 + j) * W;
      r[k] = __fmul_rn(mag, cosf(phi));
      r[F + k] = __fmul_rn(mag, sinf(phi));
    }
  }
}

// ---------------------------------------------------------------------------
// pv_resynth_kernel: one thread an output sample (stream b, band m, i).
// The overlap-add buffer of band m (length (fo-1)*hop + n_fft) is never
// written: each sample reads its two resample taps from it, and each tap is
// the sum over the frames that cover it of prod * sqrt(n_fft) * w, added to
// zero in the plain overlap-add's order (kRatio: hop divides n_fft, the
// latest frame first; else the first frame first), divided by the band's
// window-square sum, inside the centre-fit span.  A band of one frame reads
// its raw product row instead (the reference's direct inverse DFT),
// cropped to win at (n_fft - win)/2.
// ---------------------------------------------------------------------------
struct ResynthArgs {
  const float* prod;
  const int* plan;
  const float* wsq;      // [Mb, Tw] window-square sums, 1 where <= 1e-11
  const float* w;        // [n_fft] the window, centre-padded
  const float* prev;     // the carried tail, laid out as tail
  const float* fade_out;
  const float* fade_in;
  float* out;            // [B, Mb, Tb]
  float* tail;           // [B, Mb, L] (mode 2) or [Mb, L] (mode 1)
  int B, Mb, Tb, n_fft, hop, win, Tw, L, mode;
  float sqrt_n;
  long long items;
};

template <bool kRatio>
__device__ __forceinline__ float stretched(const ResynthArgs& a, int m,
                                           long long row0, int fo, int lo,
                                           int hi, int t) {
  if (fo == 1) {
    const int u = t - (a.n_fft - a.win) / 2;
    return (u >= 0 && u < a.win) ? a.prod[row0 * a.n_fft + u] : 0.0f;
  }
  if (t < lo || t >= hi) return 0.0f;
  float acc = 0.0f;
  if (kRatio) {
    const int r = t / a.hop, q = t - r * a.hop, ratio = a.n_fft / a.hop;
    for (int j = 0; j < ratio && r - j >= 0; ++j) {
      const int f = r - j, n = j * a.hop + q;
      if (f < fo)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(
            a.prod[(row0 + f) * a.n_fft + n], a.sqrt_n), a.w[n]));
    }
  } else {
    const int first = t < a.n_fft ? 0 : (t - a.n_fft) / a.hop + 1;
    const int last = min(fo - 1, t / a.hop);
    for (int f = first; f <= last; ++f) {
      const int n = t - f * a.hop;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(
          a.prod[(row0 + f) * a.n_fft + n], a.sqrt_n), a.w[n]));
    }
  }
  return __fdiv_rn(acc, a.wsq[(long long)m * a.Tw + t]);
}

template <bool kRatio>
__global__ void __launch_bounds__(kThreads)
pv_resynth_kernel(const ResynthArgs a) {
  for (long long it = global_index(); it < a.items; it += grid_stride()) {
    const int i = (int)(it % a.Tb);
    const long long bm = it / a.Tb;
    const int m = (int)(bm % a.Mb), b = (int)(bm / a.Mb);
    const int* p = a.plan + m * kPlanCols;
    const int fo = p[kFo], len = p[kLen];
    const long long row0 = (long long)a.B * p[kRow] + (long long)b * fo;

    // F.interpolate(linear, align_corners=False) of the first len samples
    const float slf = (float)len;
    float src = __fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f),
                                    __fdiv_rn(slf, (float)a.Tb)), 0.5f);
    src = fminf(fmaxf(src, 0.0f), fmaxf(__fsub_rn(slf, 1.0f), 0.0f));
    int i0 = (int)floorf(src);
    int i1 = min(i0 + 1, max(len - 1, 0));
    i0 = min(max(i0, 0), a.Tw - 1);
    i1 = min(max(i1, 0), a.Tw - 1);
    const float w1 = __fsub_rn(src, (float)i0);
    const float x0 = stretched<kRatio>(a, m, row0, fo, p[kLo], p[kHi], i0);
    const float x1 = stretched<kRatio>(a, m, row0, fo, p[kLo], p[kHi], i1);
    float y = __fadd_rn(__fmul_rn(x0, __fsub_rn(1.0f, w1)),
                        __fmul_rn(x1, w1));

    if (a.mode) {
      // tail (b, m) at (b*Mb + m)*L in both modes (mode 1 has B == 1); the
      // new tail is the shifted band before the blend
      const long long t0 = bm * a.L;
      if (i >= a.Tb - a.L) a.tail[t0 + (i - (a.Tb - a.L))] = y;
      if (i < a.L)
        y = __fadd_rn(__fmul_rn(a.prev[t0 + i], a.fade_out[i]),
                      __fmul_rn(y, a.fade_in[i]));
    }
    a.out[it] = y;
  }
}

int blocks_for(long long items) {
  const long long n = (items + kThreads - 1) / kThreads;
  return (int)(n < 1 ? 1 : (n > (1 << 30) ? (1 << 30) : n));
}

}  // namespace

extern "C" {

// frames [Mb*B, frames, n_fft] of sub [B, Mb, Tb]; w is the centre-padded
// window of n_fft (a multiple of 4).  Returns a cudaError_t.
int pqmf_pv_frame(const float* sub, const float* w, float* out, int B, int Mb,
                  int Tb, int n_fft, int hop, int frames,
                  cudaStream_t stream) {
  const long long quads = (long long)Mb * B * frames * n_fft / 4;
  pv_frame_kernel<<<blocks_for(quads), kThreads, 0, stream>>>(
      sub, w, out, B, Mb, Tb, n_fft, hop, frames, quads);
  return cudaGetLastError();
}

// rows [B * sum(fo), 2F] from spec [Mb*B, frames, 2F]; plan [Mb, 5] int32,
// rates [Mb], omega [F].  accumulate: the running-phase rule.
int pqmf_pv_spectral(const float* spec, const float* rates, const int* plan,
                     const float* omega, float* rows, int B, int Mb,
                     int n_fft, int frames, float scale, int accumulate,
                     cudaStream_t stream) {
  const int F = n_fft / 2 + 1;
  const long long items = (long long)Mb * B * F;
  if (accumulate)
    pv_spectral_kernel<true><<<blocks_for(items), kThreads, 0, stream>>>(
        spec, rates, plan, omega, rows, B, Mb, F, frames, scale, items);
  else
    pv_spectral_kernel<false><<<blocks_for(items), kThreads, 0, stream>>>(
        spec, rates, plan, omega, rows, B, Mb, F, frames, scale, items);
  return cudaGetLastError();
}

// shifted [B, Mb, Tb] (and, mode 1 or 2, the new tail) from prod
// [B * sum(fo), n_fft].  mode 0: no crossfade; 1: the reference's shared
// tail (B == 1, prev and tail [Mb, L]); 2: a tail a stream (prev and tail
// [B, Mb, L]).  prev is read densely.
int pqmf_pv_resynth(const float* prod, const int* plan, const float* wsq,
                    const float* w, const float* prev, const float* fade_out,
                    const float* fade_in, float* out, float* tail, int B,
                    int Mb, int Tb, int n_fft, int hop, int win, int Tw,
                    int L, int mode, float sqrt_n, cudaStream_t stream) {
  ResynthArgs a{prod, plan, wsq, w, prev, fade_out, fade_in, out, tail,
                B, Mb, Tb, n_fft, hop, win, Tw, L, mode, sqrt_n,
                (long long)B * Mb * Tb};
  if (n_fft % hop == 0)
    pv_resynth_kernel<true><<<blocks_for(a.items), kThreads, 0, stream>>>(a);
  else
    pv_resynth_kernel<false><<<blocks_for(a.items), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
