/* The port's native host-side data layer: sample-format conversion and the
 * windowed overlap-add accumulation of the block harness, as tight C loops
 * over caller-owned buffers.
 *
 * The counterpart of pqmf_tpu/native/wavio.c with the same arithmetic, so
 * both give the same bits, but a plain C interface over pointers and
 * lengths (loaded with ctypes, no Python headers): the Python side
 * (native/__init__.py) checks every buffer's dtype, size and contiguity
 * before it passes a pointer. Built at first use with
 *     cc -O3 -shared -fPIC wavio.c -o libpqmf_wavio_<hash>.so
 */
#include <math.h>
#include <stdint.h>

/* n little-endian PCM16 samples -> float32 in [-1, 1) */
void pqmf_pcm16_to_f32(const int16_t *src, float *dst, int64_t n)
{
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; i++)
        dst[i] = (float)src[i] * scale;
}

/* n float32 samples -> PCM16: scaled by 32767, clipped to [-32768, 32767]
 * and rounded to nearest even (lrintf), as pqmf_tpu's C encoder. Below
 * -1.0 this differs from the NumPy encoder, which clips to [-1, 1] first:
 * -1.00002 encodes as -32768 here, -32767 there. */
void pqmf_f32_to_pcm16(const float *src, int16_t *dst, int64_t n)
{
    for (int64_t i = 0; i < n; i++) {
        float v = src[i] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        dst[i] = (int16_t)lrintf(v);
    }
}

/* n packed little-endian PCM24 samples (3 bytes each) -> float32 */
void pqmf_pcm24_to_f32(const uint8_t *src, float *dst, int64_t n)
{
    const float scale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n; i++) {
        int32_t v = (int32_t)src[3 * i] | ((int32_t)src[3 * i + 1] << 8)
                    | ((int32_t)src[3 * i + 2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        dst[i] = (float)v * scale;
    }
}

/* out[offset+i] += block[i] * window[i]; norm[offset+i] += window[i]^2 for
 * i below the shorter of block and window, clipped to both accumulators'
 * bounds. */
void pqmf_ola_accumulate(float *out, int64_t n_out, float *norm,
                         int64_t n_norm, const float *block, int64_t n_block,
                         const float *window, int64_t n_window,
                         int64_t offset)
{
    int64_t n = n_block < n_window ? n_block : n_window;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = offset + i;
        if (j < 0 || j >= n_out || j >= n_norm)
            continue;
        out[j] += block[i] * window[i];
        norm[j] += window[i] * window[i];
    }
}
