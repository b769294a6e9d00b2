// Fused windowed resampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   surround360_tpu/ops/pallas_remap.py::fused_window_sample
// on its non-folded grid (one window per (tile, lead); `kernel` and
// `compute_one`'s non-offsets branch).
//
// What it computes: for tile t, lead l, channel c and sample p,
//   out[t, l, c, p] = sum over taps (iy, ix) of wy * wx * padded[l, c, iy, ix]
// where the taps are the 4x4 Keys-cubic (a = -0.75) or 2x2 bilinear taps
// of the sample point (xt[t, l, p], yt[t, l, p]) in padded coordinates, and
// a tap counts only if it lies inside the (t, l) window
//   [sy[t, l], sy[t, l] + bh) x [sx[t, l], sx[t, l] + wx).
// Borders: "constant" weighs taps outside the window 0 (the padding is
// zero); "clamp" + bilinear clamps the coordinate to the source,
// "clamp" + bicubic clamps each tap to the source, before the window test.
// The TPU kernel builds the same weights as a distance kernel over the
// window's columns and contracts them on the MXU; the Keys weight is zero
// for |s| >= 2, so evaluating the taps directly gives the same sum.
//
// What bounds it on this card: each output reads 16 scattered 4-byte taps
// per channel, so it is limited by memory latency and L1/L2 traffic, not
// by arithmetic (about 100 FLOPs per output against 64 loaded floats).
// This first design keeps it simple: one thread per (t, l, p) sample, the
// tap geometry computed once in registers, the channel loop innermost so
// the four channels reuse it, taps read straight from device memory
// through the read-only cache. No shared-memory staging of windows: at the
// 6k geometry a stage-1 window reaches 124 rows x >= 128 columns x 4
// channels x 4 B (~254 KB), more than a block's 227 KB.
//
// Robustness: a non-finite coordinate gives a zero sample; the window
// test is done in float before any integer index is formed, so far-away
// coordinates never produce an index; every read is also guarded by
// 0 <= iy < Hp, 0 <= ix < Wp; offsets into `padded` are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kA = -0.75f;

__device__ __forceinline__ float k01(float s) {
  return ((kA + 2.0f) * s - (kA + 3.0f)) * s * s + 1.0f;
}

__device__ __forceinline__ float k12(float s) {
  return ((kA * s - 5.0f * kA) * s + 8.0f * kA) * s - 4.0f * kA;
}

// Taps of one axis. v: coordinate in padded units; origin/extent: the
// window; pad/n: where the source lies in padded units; limit: padded size.
// Writes up to 4 (index, weight) pairs; masked taps get weight 0 and
// index -1 and are skipped by the caller.
__device__ __forceinline__ void axis_taps(
    float v, int origin, int extent, int pad, int n, int limit, bool bicubic,
    bool clamp, int idx[4], float w[4]) {
  if (clamp && !bicubic) {
    v = fminf(fmaxf(v - (float)pad, 0.0f), (float)(n - 1)) + (float)pad;
  } else if (clamp) {
    // beyond these bounds every tap clamps onto the same border pixel
    v = fminf(fmaxf(v, (float)(pad - 3)), (float)(pad + n + 2));
  }
  float f = floorf(v);
  const float t = v - f;
  if (bicubic) {
    w[0] = k12(t + 1.0f);
    w[1] = k01(t);
    w[2] = k01(1.0f - t);
    w[3] = k12(2.0f - t);
  } else {
    w[0] = 1.0f - t;
    w[1] = t;
    w[2] = 0.0f;
    w[3] = 0.0f;
  }
  // every tap of an f outside this range lies outside the window
  f = fminf(fmaxf(f, (float)(origin - 3)), (float)(origin + extent + 1));
  const int i0 = (int)f;
  const int ntaps = bicubic ? 4 : 2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i = bicubic ? i0 - 1 + k : i0 + k;
    if (clamp && bicubic) i = min(max(i, pad), pad + n - 1);
    const bool ok = k < ntaps && i >= origin && i < origin + extent &&
                    i >= 0 && i < limit;
    idx[k] = ok ? i : -1;
    if (!ok) w[k] = 0.0f;
  }
}

__global__ void fused_window_sample_kernel(
    const float* __restrict__ padded, const int* __restrict__ sy,
    const int* __restrict__ sx, const float* __restrict__ xt,
    const float* __restrict__ yt, float* __restrict__ out, int64_t n_samples,
    int L, int C, int Hp, int Wp, int P, int bh, int wx, int pad_y,
    int pad_x, int n_y, int n_x, bool bicubic, bool clamp) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  const int64_t tl = s / P;  // (t * L + l)
  const int p = (int)(s - tl * P);
  const int l = (int)(tl % L);
  const float x = xt[s];
  const float y = yt[s];
  float* o = out + tl * C * P + p;
  if (!isfinite(x) || !isfinite(y)) {
    for (int c = 0; c < C; ++c) o[(int64_t)c * P] = 0.0f;
    return;
  }
  int iy[4], ix[4];
  float wy[4], wxv[4];
  axis_taps(y, sy[tl], bh, pad_y, n_y, Hp, bicubic, clamp, iy, wy);
  axis_taps(x, sx[tl], wx, pad_x, n_x, Wp, bicubic, clamp, ix, wxv);
  const int64_t plane = (int64_t)Hp * Wp;
  const float* src = padded + (int64_t)l * C * plane;
  for (int c = 0; c < C; ++c) {
    const float* img = src + (int64_t)c * plane;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (iy[a] < 0) continue;
      const float* row = img + (int64_t)iy[a] * Wp;
      float r = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (ix[b] < 0) continue;
        r += wxv[b] * __ldg(row + ix[b]);
      }
      acc += wy[a] * r;
    }
    o[(int64_t)c * P] = acc;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Arrays are contiguous:
// padded (L, C, Hp, Wp) f32; sy, sx (T, L) int32; xt, yt (T, L, P) f32;
// out (T, L, C, P) f32. Launches on `stream` and returns the launch's
// cudaGetLastError().
extern "C" int s360_fused_window_sample(
    const float* padded, const int* sy, const int* sx, const float* xt,
    const float* yt, float* out, int T, int L, int C, int Hp, int Wp, int P,
    int bh, int wx, int pad_y, int pad_x, int n_y, int n_x, int bicubic,
    int clamp, void* stream) {
  const int64_t n_samples = (int64_t)T * L * P;
  if (n_samples == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_samples + threads - 1) / threads;
  fused_window_sample_kernel<<<(unsigned int)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      padded, sy, sx, xt, yt, out, n_samples, L, C, Hp, Wp, P, bh, wx, pad_y,
      pad_x, n_y, n_x, bicubic != 0, clamp != 0);
  return (int)cudaGetLastError();
}
