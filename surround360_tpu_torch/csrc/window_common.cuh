// Shared pieces of the staged window kernels for Hopper (sm_90a):
// csrc/fused_window_sample.cu (K1) and csrc/fused_window_folded.cu (K2,
// K3) include this header.
//
// The design, common to all three. One thread block takes one (tile,
// lead) window and a fixed band of the tile's samples: up to NTHR x spt
// consecutive samples p, i.e. a band of the tile's rows, each thread
// holding spt <= 4 of them (NTHR, the block's threads: see Shape).
// 1. Box. Each thread computes its samples' tap ranges; a block reduction
//    over them gives the bounding box of every tap the block can read,
//    clipped to the window (or its interior) and to the array.
// 2. Stage. The box (or, in K1, each row's own span of it) is copied from
//    the C channel planes into shared memory with 4-byte cp.async copies,
//    laid out channel-interleaved (CP = 1, 2 or 4 floats a pixel; C = 3
//    pads to 4): one tap is then one 8- or 16-byte shared load for every
//    channel. Copies are 4 bytes wide because the planes are planar in
//    device memory and interleaved in shared memory (no 16-byte copy can
//    land interleaved); a lane keeps one channel and the warp takes 32 / CP
//    consecutive columns of each plane, so each request reads whole 32-byte
//    sectors and writes consecutive shared words.
// 3. Sample. Each thread evaluates its samples from shared memory. The tap
//    count is a compile-time constant (2 x 2 bilinear, 4 x 4 bicubic) and
//    the loops carry no branch per tap: a tap that does not count reads a
//    staged pixel with weight 0, which adds an exact 0.
// 4. Write each output channel row coalesced along p.
// A region larger than the shared-memory allocation is walked in row
// bands inside the kernel: each band is staged in turn and every sample
// with a tap row in it adds those rows. Channels beyond 4 go to further
// blocks (blockIdx.y), 4 at a time.
//
// Semantics kept from the first design: the window test is done in float
// before any integer index is formed, so far-away coordinates never make
// an index; non-finite coordinates give 0; taps outside the window (or
// its interior) weigh 0; a tap outside the array is outside the staged
// region and weighs 0 (the region's bounds are the array guard); "clamp"
// + bilinear clamps the coordinate to the source, "clamp" + bicubic clamps
// each tap to it, before the window test. Taps are summed in the twin's
// order, x within a row, then rows.

#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s360 {

constexpr int kMaxSpt = 4;  // samples per thread
constexpr int kSmemMax = 232448;  // 227 KB, a block's most on sm_90
constexpr int kSms = 132;

// Block shapes, NTHR threads. A (tile, lead) of more than kBigTile samples
// (the static warps' 16 x 128 tiles, whose boxes are the tallest) takes
// 256-thread blocks of up to 1024 samples; a smaller one takes 128-thread
// blocks, twice as many an SM, whose phases (coordinates, copies,
// arithmetic) then overlap better. A thread keeps to 64 registers (launch
// bounds), so kPerSm blocks fill an SM's 64 K registers, and each takes
// its share of the SM's 228 KB of shared memory (less 1 KB a block).
constexpr int kBigTile = 1024;
template <int NTHR>
struct Shape {
  static constexpr int kPerSm = 65536 / (64 * NTHR);
  static constexpr int kBudget = 233472 / kPerSm - 1024 - 64;
};
constexpr float kA = -0.75f;

__device__ __forceinline__ float k01(float s) {
  return ((kA + 2.0f) * s - (kA + 3.0f)) * s * s + 1.0f;
}

__device__ __forceinline__ float k12(float s) {
  return ((kA * s - 5.0f * kA) * s + 8.0f * kA) * s - 4.0f * kA;
}

// One axis of a sample: v (in padded units) clamped as the border says
// ("clamp" + bilinear clamps the coordinate to the source [pad, pad + n));
// returns the first tap's index, before any per-tap clamp, and sets t, the
// fraction. floor(v) is limited to [origin - 3, origin + extent + 1] of the
// window [origin, origin + extent) first: beyond it every tap lies outside
// the window, and a far-away coordinate forms no far-away index.
template <bool kCubic>
__device__ __forceinline__ int axis_base(float v, int origin, int extent,
                                         int pad, int n, bool clamp, float& t) {
  if (clamp && !kCubic) {
    v = fminf(fmaxf(v - (float)pad, 0.0f), (float)(n - 1)) + (float)pad;
  } else if (clamp) {
    // beyond these bounds every tap clamps onto the same border pixel
    v = fminf(fmaxf(v, (float)(pad - 3)), (float)(pad + n + 2));
  }
  float f = floorf(v);
  t = v - f;
  f = fminf(fmaxf(f, (float)(origin - 3)), (float)(origin + extent + 1));
  return (int)f - (kCubic ? 1 : 0);
}

// The taps' weights: Keys cubic (a = -0.75) or bilinear.
template <bool kCubic>
__device__ __forceinline__ void tap_weights(float t, float w[4]) {
  if (kCubic) {
    w[0] = k12(t + 1.0f);
    w[1] = k01(t);
    w[2] = k01(1.0f - t);
    w[3] = k12(2.0f - t);
  } else {
    w[0] = 1.0f - t;
    w[1] = t;
  }
}

// The taps from the first one: "clamp" + bicubic clamps each tap to the
// source; ok: the tap lies in the window [origin, origin + extent), and
// the weights of the others become 0. Whether a tap lies in the array is
// left to the staged box.
template <bool kCubic>
__device__ __forceinline__ void taps_from(int first, int origin, int extent,
                                          int pad, int n, bool clamp,
                                          int idx[4], float w[4], bool ok[4]) {
#pragma unroll
  for (int k = 0; k < (kCubic ? 4 : 2); ++k) {
    int i = first + k;
    if (clamp && kCubic) i = min(max(i, pad), pad + n - 1);
    ok[k] = i >= origin && i < origin + extent;
    idx[k] = i;
    if (!ok[k]) w[k] = 0.0f;
  }
}

// All of axis_base, tap_weights and taps_from.
template <bool kCubic>
__device__ __forceinline__ void axis_taps(float v, int origin, int extent,
                                          int pad, int n, bool clamp,
                                          int idx[4], float w[4], bool ok[4]) {
  float t;
  const int first = axis_base<kCubic>(v, origin, extent, pad, n, clamp, t);
  tap_weights<kCubic>(t, w);
  taps_from<kCubic>(first, origin, extent, pad, n, clamp, idx, w, ok);
}

// Whether the taps from `first` are the consecutive indices first, first
// + 1, ... (no per-tap clamp moves them) and all lie in [lo, hi], a
// staged range inside the window and the array: then none needs a mask.
template <bool kCubic>
__device__ __forceinline__ bool taps_inside(int first, int lo, int hi, int pad,
                                            int n, bool clamp) {
  constexpr int last = kCubic ? 3 : 1;
  const bool unclamped =
      !(clamp && kCubic) || (first >= pad && first + last <= pad + n - 1);
  return unclamped && first >= lo && first + last <= hi;
}

// [lo, hi]: the range of the counted taps of taps_from(first, ...), as
// plain arithmetic (the taps are consecutive, and a per-tap clamp keeps
// them in order); lo > hi when none counts.
template <bool kCubic>
__device__ __forceinline__ void tap_span(int first, int origin, int extent,
                                         int pad, int n, bool clamp, int& lo,
                                         int& hi) {
  int a = first, b = first + (kCubic ? 3 : 1);
  if (clamp && kCubic) {
    a = min(max(a, pad), pad + n - 1);
    b = min(max(b, pad), pad + n - 1);
  }
  lo = max(a, origin);
  hi = min(b, origin + extent - 1);
}

// Rebase counted taps onto the staged [lo, lo + extent): a tap outside it
// (outside the band, or the array) or not counted gets weight 0 and the
// staged index 0. Returns whether any tap lies in it.
template <int NT>
__device__ __forceinline__ bool rebase_taps(int idx[4], float w[4],
                                            const bool ok[4], int lo,
                                            int extent) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int r = idx[k] - lo;
    const bool in = ok[k] && r >= 0 && r < extent;
    idx[k] = in ? r : 0;
    w[k] = in ? w[k] : 0.0f;
    any |= in;
  }
  return any;
}

struct Box {
  int y0, y1, x0, x1;  // inclusive; empty when y0 > y1
};

// Block-wide bounding box of the threads' ranges (a thread with none
// passes lo = INT_MAX, hi = INT_MIN). Every thread of the block calls it.
__device__ __forceinline__ Box block_box(int ylo, int yhi, int xlo, int xhi) {
  __shared__ int s[4];
  if (threadIdx.x == 0) {
    s[0] = INT_MAX;
    s[1] = INT_MIN;
    s[2] = INT_MAX;
    s[3] = INT_MIN;
  }
  __syncthreads();
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s[0], ylo);
    atomicMax(&s[1], yhi);
    atomicMin(&s[2], xlo);
    atomicMax(&s[3], xhi);
  }
  __syncthreads();
  Box b;
  b.y0 = s[0];
  b.y1 = s[1];
  b.x0 = s[2];
  b.x1 = s[3];
  return b;
}

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n pixels of a row from the planes at g (plane stride `plane`, cg
// of CP real) to dst as CP-float pixels. A lane keeps one channel
// (lane % CP) and takes every (32 / CP)-th pixel, so each warp request
// reads 32 / CP consecutive floats of each plane and writes 32
// consecutive shared words.
template <int CP>
__device__ __forceinline__ void copy_row(float* dst, const float* __restrict__ g,
                                         int64_t plane, int cg, int n) {
  const int lane = threadIdx.x & 31;
  const int c = lane % CP;
  if (c >= cg) return;
  const float* gc = g + c * plane;
  float* d = dst + c;
  for (int px = lane / CP; px < n; px += 32 / CP) cp_async4(d + px * CP, gc + px);
}

// Stage rows [y0, y0 + rows) x columns [x0, x0 + bw) into smem (rows of
// pitch bw), each warp a row at a time; returns when the copies have
// landed and the block has synchronized.
template <int CP>
__device__ __forceinline__ void stage_box(float* smem, const float* __restrict__ src,
                                          int64_t plane, int Wp, int cg, int y0,
                                          int rows, int x0, int bw) {
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    copy_row<CP>(smem + r * bw * CP, src + (int64_t)(y0 + r) * Wp + x0, plane,
                 cg, bw);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Row spans: entry r of a table is (lo, hi, off, -): window row r stages
// source columns [lo, hi] at pixel off of the region, its rows packed one
// after the other. Stage its rows [rb, re) (window rows; oy the window's
// first source row), then synchronize.
template <int CP>
__device__ __forceinline__ void stage_rows(float* smem, const int4* tab,
                                           const float* __restrict__ src,
                                           int64_t plane, int Wp, int cg,
                                           int oy, int rb, int re) {
  const int off0 = tab[rb].z;
  for (int r = rb + (threadIdx.x >> 5); r < re; r += blockDim.x >> 5) {
    const int4 e = tab[r];
    copy_row<CP>(smem + (e.z - off0) * CP, src + (int64_t)(oy + r) * Wp + e.x,
                 plane, cg, e.y - e.x + 1);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// One staged pixel's CP channels.
template <int CP>
__device__ __forceinline__ void load_px(const float* s, float v[CP]) {
  if constexpr (CP == 4) {
    const float4 q = *reinterpret_cast<const float4*>(s);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (CP == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *s;
  }
}

// Samples per thread: as many as a (tile, lead)'s P samples need, at
// most kMaxSpt, and fewer where the launch would then not fill the SMs
// once.
inline int pick_spt(int64_t tl, int P, int nthr, int per_sm) {
  int spt = (P + nthr - 1) / nthr;
  spt = spt < kMaxSpt ? spt : kMaxSpt;
  while (spt > 1 && tl * ((P + nthr * spt - 1) / (nthr * spt)) < kSms * per_sm) {
    --spt;
  }
  return spt;
}

// Dynamic shared memory of a launch: a table of tab_rows 16-byte row
// spans, then the staging area, which holds the whole rows x wx window of
// CP-float pixels when that fits the block's budget, else what the budget
// leaves (and never less than one window row, so a band holds >= 1 row).
// Sets *stage_px to the staging area's pixels; 0 when a block's shared
// memory cannot hold the table and one row.
inline int pick_smem(int rows, int wx, int CP, int tab_rows, int budget,
                     int* stage_px) {
  const int64_t tab = (int64_t)tab_rows * 16;
  const int64_t row = (int64_t)wx * CP * 4;
  int64_t stg = (int64_t)rows * row;
  if (stg > budget - tab) stg = budget - tab;
  if (stg < row) stg = row;
  stg = (stg + 15) / 16 * 16;
  *stage_px = (int)(stg / (CP * 4));
  return tab + stg > kSmemMax ? 0 : (int)(tab + stg);
}

// K1 and K2: one windowed field. Origins per (tile, lead) (K1) or per tile
// (kFolded, K2). Grid: x = (l * T + t) * nchunk + chunk, lead-major so that
// the blocks resident at once sample neighbouring tiles of one source;
// y = channel group. Shared memory: a row-span table of the bh window
// rows (+ 1 end entry), then the staging area of stage_px pixels.
//
// Once the taps come from shared memory, the copies into it and the
// samples' arithmetic are the two costs left, of like size at the side
// projection. So
// - a K1 block whose bounding box holds more than 3 pixels a sample stages
//   only the columns each row's taps reach (row spans, built with shared
//   atomics, one per group of lanes with the same tap rows): the side
//   projection's samples cross the source on a slant and the fisheye
//   strip's on arcs, so their boxes are mostly empty; a compact block
//   stages its box and pays nothing for the table (nor does K2, whose
//   blocks hold several candidates' copies of one tile);
// - a sample whose taps all lie inside the staged rows (nearly all of
//   them) takes a path with no per-tap mask: its taps are consecutive
//   staged pixels, one address a row and constant offsets along it.
template <int NTHR, int CP, bool kCubic, bool kFolded>
__global__ void __launch_bounds__(NTHR, Shape<NTHR>::kPerSm)
window_sample_kernel(const float* __restrict__ padded, const int* __restrict__ sy,
                     const int* __restrict__ sx, const float* __restrict__ xt,
                     const float* __restrict__ yt, float* __restrict__ out,
                     int T, int L, int C, int Hp, int Wp, int P, int nchunk,
                     int spt, int bh, int wx, int pad_y, int pad_x, int n_y,
                     int n_x, bool clamp, int stage_px) {
  constexpr int NT = kCubic ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  int4* tab = reinterpret_cast<int4*>(smem);
  float* stg = smem + 4 * (bh + 1);
  const int chunk = (int)(blockIdx.x % nchunk);
  const int t = (int)(blockIdx.x / nchunk % T);
  const int l = (int)(blockIdx.x / nchunk / T);
  const int64_t tl = (int64_t)t * L + l;
  const int c0 = blockIdx.y * CP;
  const int cg = min(CP, C - c0);
  const int64_t origin = kFolded ? t : tl;
  const int oy = sy[origin];
  const int ox = sx[origin];
  const int lane = threadIdx.x & 31;
  const int p0 = chunk * NTHR * spt + threadIdx.x;
  const float* xrow = xt + tl * P;
  const float* yrow = yt + tl * P;

  // a sample's counted tap rows [a0, a1] and columns [b0, b1], clipped to
  // the array; empty (a0 > a1) for a non-finite coordinate
  auto spans = [&](float x, float y, int& a0, int& a1, int& b0, int& b1) {
    a0 = 0, a1 = -1, b0 = 0, b1 = -1;
    if (!isfinite(x) || !isfinite(y)) return;
    float f;
    tap_span<kCubic>(axis_base<kCubic>(y, oy, bh, pad_y, n_y, clamp, f), oy, bh,
                     pad_y, n_y, clamp, a0, a1);
    tap_span<kCubic>(axis_base<kCubic>(x, ox, wx, pad_x, n_x, clamp, f), ox, wx,
                     pad_x, n_x, clamp, b0, b1);
    a0 = max(a0, 0);
    a1 = min(a1, Hp - 1);
    b0 = max(b0, 0);
    b1 = min(b1, Wp - 1);
    if (b0 > b1) a1 = a0 - 1;
  };

  // 1. the box of the block's taps (a sample past P reads as NaN)
  float xs[kMaxSpt], ys[kMaxSpt];
  int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
#pragma unroll
  for (int k = 0; k < kMaxSpt; ++k) {
    const int p = p0 + k * NTHR;
    const bool in = k < spt && p < P;
    xs[k] = in ? xrow[p] : NAN;
    ys[k] = in ? yrow[p] : NAN;
    int a0, a1, b0, b1;
    spans(xs[k], ys[k], a0, a1, b0, b1);
    if (a0 > a1) continue;
    ylo = min(ylo, a0);
    yhi = max(yhi, a1);
    xlo = min(xlo, b0);
    xhi = max(xhi, b1);
  }
  const Box box = block_box(ylo, yhi, xlo, xhi);

  // 2. + 3. stage each band of rows, then add its taps to the samples'
  // sums, which stay in registers until the last band
  float acc[kMaxSpt][CP];
#pragma unroll
  for (int k = 0; k < kMaxSpt; ++k) {
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[k][c] = 0.0f;
  }
  if (box.y0 <= box.y1) {  // else no tap of the block counts: all zeros
    const int r0 = box.y0 - oy, rend = box.y1 - oy + 1;  // window rows
    const int bw = box.x1 - box.x0 + 1;
    const bool rowwise =
        !kFolded && (int64_t)(rend - r0) * bw > 3 * NTHR * spt;
    if (rowwise) {
      for (int r = r0 + (int)threadIdx.x; r < rend; r += NTHR) {
        tab[r] = make_int4(INT_MAX, INT_MIN, 0, 0);
      }
      __syncthreads();
      // lanes whose samples have the same tap rows merge their columns,
      // and one of them widens those rows' spans
#pragma unroll
      for (int k = 0; k < kMaxSpt; ++k) {
        int a0, a1, b0, b1;
        spans(xs[k], ys[k], a0, a1, b0, b1);
        const bool valid = a0 <= a1;
        const int key = valid ? (a0 - oy) * 4 + (a1 - a0) : -1;  // <= 4 rows
        const unsigned m = __match_any_sync(0xffffffffu, key);
        const int lo = __reduce_min_sync(m, valid ? b0 : INT_MAX);
        const int hi = __reduce_max_sync(m, valid ? b1 : INT_MIN);
        if (valid && lane == __ffs(m) - 1) {
          for (int r = a0 - oy; r <= a1 - oy; ++r) {
            atomicMin(&tab[r].x, lo);
            atomicMax(&tab[r].y, hi);
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < 32) {  // the rows' offsets: one warp's prefix sum
        int carry = 0;
        for (int i = r0 + lane; i < r0 + ((rend - r0 + 31) & ~31); i += 32) {
          int n = 0;
          if (i < rend) {
            const int4 e = tab[i];
            if (e.y >= e.x) {
              n = e.y - e.x + 1;
            } else {  // a row no tap reaches
              tab[i].x = 0;
              tab[i].y = -1;
            }
          }
          int incl = n;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += v;
          }
          if (i < rend) tab[i].z = carry + incl - n;
          carry += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (lane == 0) tab[rend].z = carry;
      }
      __syncthreads();
    }
    const int64_t plane = (int64_t)Hp * Wp;
    const float* src = padded + ((int64_t)l * C + c0) * plane;
    for (int rb = r0; rb < rend;) {
      // the band [rb, re): the most rows whose pixels fit the staging area
      int re, base;
      if (rowwise) {
        base = tab[rb].z;
        re = rb + 1;
        int hi = rend;
        while (re < hi) {
          const int mid = (re + hi + 1) >> 1;
          if (tab[mid].z - base <= stage_px) re = mid; else hi = mid - 1;
        }
      } else {
        base = (rb - r0) * bw;
        re = min(rend, rb + stage_px / bw);
      }
      if (rb != r0) __syncthreads();  // the last band's reads are done
      if (rowwise) {
        stage_rows<CP>(stg, tab, src, plane, Wp, cg, oy, rb, re);
      } else {
        stage_box<CP>(stg, src, plane, Wp, cg, oy + rb, re - rb, box.x0, bw);
      }
      // window row r of the band: staged columns [lo, hi], and the staged
      // pixel of source column 0 (so a tap's pixel is that + its column)
      auto row_span = [&](int r, int& lo, int& hi) {
        if (rowwise) {
          const int4 e = tab[r];
          lo = e.x;
          hi = e.y;
          return e.z - base - e.x;
        }
        lo = box.x0;
        hi = box.x1;
        return (r - rb) * bw - box.x0;
      };
      const int by = oy + rb, rows = re - rb;
#pragma unroll
      for (int k = 0; k < kMaxSpt; ++k) {
        if (!isfinite(xs[k]) || !isfinite(ys[k])) continue;
        float ty, tx;
        const int fy = axis_base<kCubic>(ys[k], oy, bh, pad_y, n_y, clamp, ty);
        // no tap row in this band (with "clamp" + bicubic a tap may clamp
        // into it: the masked path below sees to those)
        if (!(clamp && kCubic) && (fy + NT - 1 < by || fy >= by + rows)) continue;
        const int fx = axis_base<kCubic>(xs[k], ox, wx, pad_x, n_x, clamp, tx);
        float wy[4], wxv[4];
        tap_weights<kCubic>(ty, wy);
        tap_weights<kCubic>(tx, wxv);
        int pix[4];
        bool fast = taps_inside<kCubic>(fy, by, by + rows - 1, pad_y, n_y, clamp);
        if (fast) {
#pragma unroll
          for (int a = 0; a < NT; ++a) {
            int lo, hi;
            pix[a] = row_span(fy - oy + a, lo, hi);
            fast = fast && taps_inside<kCubic>(fx, lo, hi, pad_x, n_x, clamp);
          }
        }
        if (fast) {
#pragma unroll
          for (int a = 0; a < NT; ++a) {
            const float* q = stg + (pix[a] + fx) * CP;
            float rs[CP];
#pragma unroll
            for (int c = 0; c < CP; ++c) rs[c] = 0.0f;
#pragma unroll
            for (int b = 0; b < NT; ++b) {
              float v[CP];
              load_px<CP>(q + b * CP, v);
#pragma unroll
              for (int c = 0; c < CP; ++c) rs[c] += wxv[b] * v[c];
            }
#pragma unroll
            for (int c = 0; c < CP; ++c) acc[k][c] += wy[a] * rs[c];
          }
          continue;
        }
        // near the window, the array or the band's edges: masked taps
        int iy[4], ix[4];
        bool oky[4], okx[4];
        taps_from<kCubic>(fy, oy, bh, pad_y, n_y, clamp, iy, wy, oky);
        bool any = false;
#pragma unroll
        for (int a = 0; a < NT; ++a) {
          const int r = iy[a] - oy;
          const bool in = oky[a] && r >= rb && r < re;
          iy[a] = in ? r : rb;
          wy[a] = in ? wy[a] : 0.0f;
          any |= in;
        }
        if (!any) continue;
        taps_from<kCubic>(fx, ox, wx, pad_x, n_x, clamp, ix, wxv, okx);
#pragma unroll
        for (int a = 0; a < NT; ++a) {
          int lo, hi;
          const int px = row_span(iy[a], lo, hi);
          float rs[CP];
#pragma unroll
          for (int c = 0; c < CP; ++c) rs[c] = 0.0f;
#pragma unroll
          for (int b = 0; b < NT; ++b) {
            // outside the row's span: outside the array
            const bool in = okx[b] && ix[b] >= lo && ix[b] <= hi;
            float v[CP];
            load_px<CP>(stg + (in ? px + ix[b] : 0) * CP, v);
            const float w = in ? wxv[b] : 0.0f;
#pragma unroll
            for (int c = 0; c < CP; ++c) rs[c] += w * v[c];
          }
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[k][c] += wy[a] * rs[c];
        }
      }
      rb = re;
    }
  }

  // 4. each output channel row, coalesced along p
  float* o = out + (tl * C + c0) * P;
#pragma unroll
  for (int k = 0; k < kMaxSpt; ++k) {
    const int p = p0 + k * NTHR;
    if (k >= spt || p >= P) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (c < cg) o[(int64_t)c * P + p] = acc[k][c];
    }
  }
}

// Launch window_sample_kernel with NTHR-thread blocks (C = 1, 2 or >= 3
// picks CP = 1, 2, 4); returns the launch's error, or
// cudaErrorInvalidValue when a block's shared memory cannot hold the row
// table and one window row.
template <int NTHR, bool kFolded>
int launch_shaped(const float* padded, const int* sy, const int* sx,
                  const float* xt, const float* yt, float* out, int T, int L,
                  int C, int Hp, int Wp, int P, int bh, int wx, int pad_y,
                  int pad_x, int n_y, int n_x, bool bicubic, bool clamp,
                  cudaStream_t stream) {
  const int CP = C >= 3 ? 4 : C;
  int stage_px = 0;
  const int smem = pick_smem(bh, wx, CP, bh + 1, Shape<NTHR>::kBudget, &stage_px);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const int64_t tl = (int64_t)T * L;
  const int spt = pick_spt(tl, P, NTHR, Shape<NTHR>::kPerSm);
  const int nchunk = (P + NTHR * spt - 1) / (NTHR * spt);
  const dim3 grid((unsigned int)(tl * nchunk), (unsigned int)((C + CP - 1) / CP));
  auto go = [&](auto kernel) {
    // the opt-in counts dynamic shared memory only; the static 16 bytes
    // of block_box come on top of the default 48 KB, so always opt in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, NTHR, smem, stream>>>(
        padded, sy, sx, xt, yt, out, T, L, C, Hp, Wp, P, nchunk, spt, bh, wx,
        pad_y, pad_x, n_y, n_x, clamp, stage_px);
    return (int)cudaGetLastError();
  };
  if (bicubic) {
    if (CP == 4) return go(window_sample_kernel<NTHR, 4, true, kFolded>);
    if (CP == 2) return go(window_sample_kernel<NTHR, 2, true, kFolded>);
    return go(window_sample_kernel<NTHR, 1, true, kFolded>);
  }
  if (CP == 4) return go(window_sample_kernel<NTHR, 4, false, kFolded>);
  if (CP == 2) return go(window_sample_kernel<NTHR, 2, false, kFolded>);
  return go(window_sample_kernel<NTHR, 1, false, kFolded>);
}

// K1 (kFolded false) and K2 (true), in the block shape of P.
template <bool kFolded>
int launch_window_sample(const float* padded, const int* sy, const int* sx,
                         const float* xt, const float* yt, float* out, int T,
                         int L, int C, int Hp, int Wp, int P, int bh, int wx,
                         int pad_y, int pad_x, int n_y, int n_x, bool bicubic,
                         bool clamp, cudaStream_t stream) {
  if ((int64_t)T * L * P == 0 || C == 0) return (int)cudaSuccess;
  if (P > kBigTile) {
    return launch_shaped<256, kFolded>(padded, sy, sx, xt, yt, out, T, L, C, Hp,
                                       Wp, P, bh, wx, pad_y, pad_x, n_y, n_x,
                                       bicubic, clamp, stream);
  }
  return launch_shaped<128, kFolded>(padded, sy, sx, xt, yt, out, T, L, C, Hp,
                                     Wp, P, bh, wx, pad_y, pad_x, n_y, n_x,
                                     bicubic, clamp, stream);
}

}  // namespace s360
