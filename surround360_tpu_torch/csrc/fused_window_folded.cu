// Lead-folded windowed resampling with integer offset fields, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   surround360_tpu/ops/pallas_remap.py::fused_window_sample
// on its lead-folded grid (`kernel_folded`, pallas_call at :591), both with
// and without `offsets` (`compute_one` :301-319, `onehot(edge_mask=...)`).
//
// What it computes. Window origins sy[t], sx[t] are per tile and shared by
// every lead l. For tile t, lead l, offset o = (oy, ox), channel c, sample p:
//   out[t, l, o, c, p] = sum over taps (iy, ix) of wy * wx *
//                        padded[l, c, iy + oy, ix + ox]
// where (iy, ix) are the bilinear (or, with one zero offset, Keys-cubic)
// taps of (xt[t, l, p], yt[t, l, p]) in padded coordinates, and a tap
// counts only if it lies in the window's interior
//   [sy + my, sy + bh - my) x [sx + mx, sx + wx - mx).
// With one zero offset and zero margins (K2) this is the non-folded
// kernel's windowed sample with per-tile origins. With offsets (K3) the
// interior is the window less the offset margins: the TPU kernel builds
// one interpolation matrix over the whole window, masks its outer margin
// bands, and lane-rolls the window by each offset, so a tap whose base
// index lies in a margin band never counts. Reads outside the array give 0
// (the reference's windows lie inside the array by construction).
// Borders as in the non-folded kernel: "constant" takes the taps as they
// are; "clamp" + bilinear clamps the base coordinate to the source before
// the offset is added (pallas_remap.py:186-187); "clamp" + bicubic clamps
// each tap to the source.
//
// Design. The TPU kernel shares one interpolation-matrix build across all
// O fields. Here one thread per (t, l, p) computes the base tap geometry
// (weights and the interior test) once in registers and reuses it for all
// O x C outputs, reading padded[l, c, iy + oy, ix + ox] through the
// read-only cache; neighbouring p read neighbouring columns, and each
// output row (o, c) is written coalesced along p.
//
// What bounds it on this card: every output is 4 scattered 4-byte loads
// (bilinear), so a sample costs O * C * 16 bytes of L1/L2 traffic for
// ~30 FLOPs per output; it is bound by load latency and cache traffic, not
// by arithmetic.
//
// Robustness: a non-finite coordinate gives zero samples; the window test
// is done in float before any integer index is formed, so far-away
// coordinates never produce an index; every read is guarded by
// 0 <= iy + oy < Hp, 0 <= ix + ox < Wp; offsets into `padded` are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 16;
constexpr float kA = -0.75f;

struct Offsets {
  int n;
  int oy[kMaxOffsets];
  int ox[kMaxOffsets];
};

__device__ __forceinline__ float k01(float s) {
  return ((kA + 2.0f) * s - (kA + 3.0f)) * s * s + 1.0f;
}

__device__ __forceinline__ float k12(float s) {
  return ((kA * s - 5.0f * kA) * s + 8.0f * kA) * s - 4.0f * kA;
}

// Taps of one axis. v: coordinate in padded units; origin/extent: the
// window's interior; pad/n: where the source lies in padded units. Writes
// up to 4 (index, weight, ok) triples; taps outside the interior (or past
// the tap count) get ok = false and weight 0.
__device__ __forceinline__ void axis_taps(
    float v, int origin, int extent, int pad, int n, bool bicubic, bool clamp,
    int idx[4], float w[4], bool ok[4]) {
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
  // every tap of an f outside this range lies outside the interior
  f = fminf(fmaxf(f, (float)(origin - 3)), (float)(origin + extent + 1));
  const int i0 = (int)f;
  const int ntaps = bicubic ? 4 : 2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i = bicubic ? i0 - 1 + k : i0 + k;
    if (clamp && bicubic) i = min(max(i, pad), pad + n - 1);
    ok[k] = k < ntaps && i >= origin && i < origin + extent && i >= 0;
    idx[k] = i;
    if (!ok[k]) w[k] = 0.0f;
  }
}

__global__ void fused_window_folded_kernel(
    const float* __restrict__ padded, const int* __restrict__ sy,
    const int* __restrict__ sx, const float* __restrict__ xt,
    const float* __restrict__ yt, float* __restrict__ out, int64_t n_samples,
    int L, int C, int Hp, int Wp, int P, int bh, int wx, int my, int mx,
    int pad_y, int pad_x, int n_y, int n_x, bool bicubic, bool clamp,
    Offsets offs) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  const int64_t tl = s / P;  // (t * L + l)
  const int p = (int)(s - tl * P);
  const int t = (int)(tl / L);
  const int l = (int)(tl - (int64_t)t * L);
  const int O = offs.n;
  const float x = xt[s];
  const float y = yt[s];
  float* o_base = out + tl * O * C * P + p;
  if (!isfinite(x) || !isfinite(y)) {
    for (int k = 0; k < O * C; ++k) o_base[(int64_t)k * P] = 0.0f;
    return;
  }
  int iy[4], ix[4];
  float wy[4], wxv[4];
  bool oky[4], okx[4];
  axis_taps(y, sy[t] + my, bh - 2 * my, pad_y, n_y, bicubic, clamp, iy, wy,
            oky);
  axis_taps(x, sx[t] + mx, wx - 2 * mx, pad_x, n_x, bicubic, clamp, ix, wxv,
            okx);
  const int64_t plane = (int64_t)Hp * Wp;
  const float* src = padded + (int64_t)l * C * plane;
  for (int o = 0; o < O; ++o) {
    const int dy = offs.oy[o];
    const int dx = offs.ox[o];
    for (int c = 0; c < C; ++c) {
      const float* img = src + (int64_t)c * plane;
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int yy = iy[a] + dy;
        if (!oky[a] || yy < 0 || yy >= Hp) continue;
        const float* row = img + (int64_t)yy * Wp;
        float r = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int xx = ix[b] + dx;
          if (!okx[b] || xx < 0 || xx >= Wp) continue;
          r += wxv[b] * __ldg(row + xx);
        }
        acc += wy[a] * r;
      }
      o_base[(int64_t)(o * C + c) * P] = acc;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Arrays are contiguous device
// memory: padded (L, C, Hp, Wp) f32; sy, sx (T,) int32; xt, yt (T, L, P)
// f32; out (T, L, O, C, P) f32. off_yx is a HOST array of n_offsets
// (oy, ox) pairs. wx is the window width, my/mx the interior margins.
// Launches on `stream` and returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an offset count outside 1..kMaxOffsets.
extern "C" int s360_fused_window_folded(
    const float* padded, const int* sy, const int* sx, const float* xt,
    const float* yt, float* out, int T, int L, int C, int Hp, int Wp, int P,
    int bh, int wx, int my, int mx, int pad_y, int pad_x, int n_y, int n_x,
    int bicubic, int clamp, int n_offsets, const int* off_yx, void* stream) {
  if (n_offsets < 1 || n_offsets > kMaxOffsets) {
    return (int)cudaErrorInvalidValue;
  }
  Offsets offs;
  offs.n = n_offsets;
  for (int o = 0; o < kMaxOffsets; ++o) {
    offs.oy[o] = o < n_offsets ? off_yx[2 * o] : 0;
    offs.ox[o] = o < n_offsets ? off_yx[2 * o + 1] : 0;
  }
  const int64_t n_samples = (int64_t)T * L * P;
  if (n_samples == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_samples + threads - 1) / threads;
  fused_window_folded_kernel<<<(unsigned int)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      padded, sy, sx, xt, yt, out, n_samples, L, C, Hp, Wp, P, bh, wx, my,
      mx, pad_y, pad_x, n_y, n_x, bicubic != 0, clamp != 0, offs);
  return (int)cudaGetLastError();
}
