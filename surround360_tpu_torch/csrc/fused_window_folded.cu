// Lead-folded windowed resampling with integer offset fields, for Hopper
// (sm_90a): K2 and K3.
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
// What bounds it on this card: device-memory bytes, and the output above
// all: a K3 sample writes O x C x 4 B (72 B for the flow's 9 offsets x 2
// channels) against 8 B of coordinates and ~2 source pixels. The first
// design read 4 scalar taps per output (72 loads per sample; at d = 1 the
// nine 2x2 patches cover one 4x4 neighbourhood, 16 pixels read 36 times)
// from L1/L2, so load issue and cache traffic set its time.
//
// What this design does about it (window_common.cuh for the common
// steps): a block per tile, lead and band of the tile's rows stages the
// box of its own base taps, clipped to the interior and widened by the
// offsets' reach, into shared memory as float2 at C = 2 (K2: the box of
// its taps, as K1). Each sample computes its base tap geometry once and
// derives all O fields from shared memory (4 shared loads a field), the
// offsets unrolled over a compile-time bound with the (oy, ox) pairs as
// kernel parameters. Each output row (o, c) is written coalesced along p;
// the output, not the source, is most of what K3 moves: forming the d = 1
// round's nine fields from one 4x4 patch in registers (16 shared loads,
// not 36) made it no faster on the H100.

#include <type_traits>

#include "window_common.cuh"

namespace {

using namespace s360;

constexpr int kMaxOffsets = 16;

struct Offsets {
  int n;
  int oy[kMaxOffsets];
  int ox[kMaxOffsets];
  int oy_min, oy_max, ox_min, ox_max;
};

// A field's output: stored by the first band of a box, added to by the
// later ones (K3's boxes take one band on the product path, so its O x C
// sums wait in device memory rather than in registers).
__device__ __forceinline__ void put(float* q, float v, bool first) {
  *q = first ? v : *q + v;
}

// K3: O offset fields from one window per tile, bilinear. Grid as
// window_sample_kernel's (lead-major).
template <int NTHR, int CP>
__global__ void __launch_bounds__(NTHR, Shape<NTHR>::kPerSm)
window_offsets_kernel(const float* __restrict__ padded, const int* __restrict__ sy,
                      const int* __restrict__ sx, const float* __restrict__ xt,
                      const float* __restrict__ yt, float* __restrict__ out,
                      int T, int L, int C, int Hp, int Wp, int P, int nchunk,
                      int spt, int bh, int wx, int my, int mx, int pad_y, int pad_x,
                      int n_y, int n_x, bool clamp, const Offsets offs,
                      int stage_px) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = (int)(blockIdx.x % nchunk);
  const int t = (int)(blockIdx.x / nchunk % T);
  const int l = (int)(blockIdx.x / nchunk / T);
  const int64_t tl = (int64_t)t * L + l;
  const int c0 = blockIdx.y * CP;
  const int cg = min(CP, C - c0);
  const int O = offs.n;
  const int iy0 = sy[t] + my, ey = bh - 2 * my;  // the interior
  const int ix0 = sx[t] + mx, ex = wx - 2 * mx;
  const int p0 = chunk * NTHR * spt + threadIdx.x;
  const float* xrow = xt + tl * P;
  const float* yrow = yt + tl * P;

  // 1. the box: the base taps' range, widened by the offsets' reach
  int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
#pragma unroll
  for (int k = 0; k < kMaxSpt; ++k) {
    const int p = p0 + k * NTHR;
    if (k >= spt || p >= P) continue;
    const float x = xrow[p], y = yrow[p];
    if (!isfinite(x) || !isfinite(y)) continue;
    float t;
    int a0, a1, b0, b1;
    tap_span<false>(axis_base<false>(y, iy0, ey, pad_y, n_y, clamp, t), iy0, ey,
                    pad_y, n_y, clamp, a0, a1);
    tap_span<false>(axis_base<false>(x, ix0, ex, pad_x, n_x, clamp, t), ix0, ex,
                    pad_x, n_x, clamp, b0, b1);
    if (a0 > a1 || b0 > b1) continue;
    a0 = max(a0 + offs.oy_min, 0);
    a1 = min(a1 + offs.oy_max, Hp - 1);
    b0 = max(b0 + offs.ox_min, 0);
    b1 = min(b1 + offs.ox_max, Wp - 1);
    if (a0 > a1 || b0 > b1) continue;
    ylo = min(ylo, a0);
    yhi = max(yhi, a1);
    xlo = min(xlo, b0);
    xhi = max(xhi, b1);
  }
  const Box box = block_box(ylo, yhi, xlo, xhi);

  float* o_base = out + tl * O * C * P + (int64_t)c0 * P;  // + (o C + c) P + p
  if (box.y0 > box.y1) {  // no tap of the block counts: all zeros
    for (int k = 0; k < spt; ++k) {
      const int p = p0 + k * NTHR;
      if (p >= P) break;
      for (int o = 0; o < O; ++o) {
        for (int c = 0; c < cg; ++c) o_base[(int64_t)(o * C + c) * P + p] = 0.0f;
      }
    }
    return;
  }
  const int64_t plane = (int64_t)Hp * Wp;
  const float* src = padded + ((int64_t)l * C + c0) * plane;
  const int bw = box.x1 - box.x0 + 1;
  const int band = min(box.y1 - box.y0 + 1, stage_px / bw);

  for (int by = box.y0; by <= box.y1; by += band) {
    const int rows = min(band, box.y1 - by + 1);
    if (by != box.y0) __syncthreads();  // the last band's reads are done
    stage_box<CP>(smem, src, plane, Wp, cg, by, rows, box.x0, bw);
    const bool first = by == box.y0;
    // one sample at a time (its O x C outputs are the registers' work);
    // its coordinates come again from L1
#pragma unroll 1
    for (int k = 0; k < spt; ++k) {
      const int p = p0 + k * NTHR;
      if (p >= P) break;
      const float x = xrow[p], y = yrow[p];
      const bool finite = isfinite(x) && isfinite(y);
      int iy[4], ix[4];
      float wy[4], wxv[4];
      bool oky[4], okx[4];
      axis_taps<false>(finite ? y : 0.0f, iy0, ey, pad_y, n_y, clamp, iy, wy, oky);
      axis_taps<false>(finite ? x : 0.0f, ix0, ex, pad_x, n_x, clamp, ix, wxv, okx);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        oky[a] = oky[a] && finite;
        okx[a] = okx[a] && finite;
        wy[a] = oky[a] ? wy[a] : 0.0f;
        wxv[a] = okx[a] ? wxv[a] : 0.0f;
      }
      float* dst = o_base + p;
#pragma unroll
      for (int o = 0; o < kMaxOffsets; ++o) {
        if (o >= O) break;
        int r[4], cc[4];
        float wr[4], wc[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          r[a] = iy[a] + offs.oy[o];
          wr[a] = wy[a];
          cc[a] = ix[a] + offs.ox[o];
          wc[a] = wxv[a];
        }
        rebase_taps<2>(r, wr, oky, by, rows);
        rebase_taps<2>(cc, wc, okx, box.x0, bw);
        float acc[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[c] = 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float rs[CP];
#pragma unroll
          for (int c = 0; c < CP; ++c) rs[c] = 0.0f;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float v[CP];
            load_px<CP>(smem + (r[a] * bw + cc[b]) * CP, v);
#pragma unroll
            for (int c = 0; c < CP; ++c) rs[c] += wc[b] * v[c];
          }
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[c] += wr[a] * rs[c];
        }
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          if (c < cg) put(dst + (int64_t)(o * C + c) * P, acc[c], first);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Arrays are contiguous device
// memory: padded (L, C, Hp, Wp) f32; sy, sx (T,) int32; xt, yt (T, L, P)
// f32; out (T, L, O, C, P) f32. off_yx is a HOST array of n_offsets
// (oy, ox) pairs. wx is the window width, my/mx the interior margins. One
// zero offset with zero margins is K2 (bicubic or bilinear); anything else
// is K3 (bilinear only). Launches on `stream` and returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for an offset count outside
// 1..kMaxOffsets, bicubic offsets, or a window row of C channels beyond a
// block's shared memory.
extern "C" int s360_fused_window_folded(
    const float* padded, const int* sy, const int* sx, const float* xt,
    const float* yt, float* out, int T, int L, int C, int Hp, int Wp, int P,
    int bh, int wx, int my, int mx, int pad_y, int pad_x, int n_y, int n_x,
    int bicubic, int clamp, int n_offsets, const int* off_yx, void* stream) {
  if (n_offsets < 1 || n_offsets > kMaxOffsets) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_offsets == 1 && off_yx[0] == 0 && off_yx[1] == 0 && my == 0 && mx == 0) {
    return launch_window_sample<true>(padded, sy, sx, xt, yt, out, T, L, C, Hp,
                                      Wp, P, bh, wx, pad_y, pad_x, n_y, n_x,
                                      bicubic != 0, clamp != 0, st);
  }
  if (bicubic) return (int)cudaErrorInvalidValue;
  Offsets offs;
  offs.n = n_offsets;
  offs.oy_min = offs.ox_min = INT_MAX;
  offs.oy_max = offs.ox_max = INT_MIN;
  for (int o = 0; o < kMaxOffsets; ++o) {
    const int oy = o < n_offsets ? off_yx[2 * o] : 0;
    const int ox = o < n_offsets ? off_yx[2 * o + 1] : 0;
    offs.oy[o] = oy;
    offs.ox[o] = ox;
    if (o >= n_offsets) continue;
    offs.oy_min = min(offs.oy_min, oy);
    offs.oy_max = max(offs.oy_max, oy);
    offs.ox_min = min(offs.ox_min, ox);
    offs.ox_max = max(offs.ox_max, ox);
  }
  if ((int64_t)T * L * P == 0 || C == 0) return (int)cudaSuccess;
  const int CP = C >= 3 ? 4 : C;
  auto shaped = [&](auto nthr) {
    constexpr int NTHR = decltype(nthr)::value;
    int stage_px = 0;
    const int smem =
        pick_smem(bh, wx, CP, 0, Shape<NTHR>::kBudget, &stage_px);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int64_t tl = (int64_t)T * L;
    const int spt = pick_spt(tl, P, NTHR, Shape<NTHR>::kPerSm);
    const int nchunk = (P + NTHR * spt - 1) / (NTHR * spt);
    const dim3 grid((unsigned int)(tl * nchunk), (unsigned int)((C + CP - 1) / CP));
    auto go = [&](auto kernel) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, NTHR, smem, st>>>(
          padded, sy, sx, xt, yt, out, T, L, C, Hp, Wp, P, nchunk, spt, bh, wx,
          my, mx, pad_y, pad_x, n_y, n_x, clamp != 0, offs, stage_px);
      return (int)cudaGetLastError();
    };
    if (CP == 4) return go(window_offsets_kernel<NTHR, 4>);
    if (CP == 2) return go(window_offsets_kernel<NTHR, 2>);
    return go(window_offsets_kernel<NTHR, 1>);
  };
  if (P > kBigTile) return shaped(std::integral_constant<int, 256>());
  return shaped(std::integral_constant<int, 128>());
}
