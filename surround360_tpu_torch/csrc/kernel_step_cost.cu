// The step-cost probes for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU kernels of benchmarks/kernel_step_cost.py::main
// (`variant`, pallas_call :121, with the bodies body_dots / body_tent /
// body_roll; `make_dyn`, :217; `make_dma`, :284). Each is an (n_steps,)
// grid whose step runs the same body at the side-flow level-0 ranking
// geometry: a window of C = 2 channels x BH = 64 rows x BW = 512 lanes,
// PG = 512 samples a step.
//
// What a step computes (x is (n, 8, PG), the window (C, BH, BW)):
//   variant: for o < 5, out[step, o, p] = sum_{h < 64} sum_k A[p, k] *
//            w[h, (k - o * roll) mod BW], with A[p, k] = k * (x[step,0,0] *
//            1e-6) + o (dots) or the bicubic (a = -0.75) tent |x[step, 0, p]
//            - k| (tent, roll);
//   dyn:     for lead l < 8, out[step, l, p] = sum_h sum_k tent(x[step, l,
//            p] - k) * w[h, k], as a runtime loop (fori) or unrolled;
//   dma:     the tent body on the window rows [oy, oy + 64) of a taller
//            array, oy = (int(x[step, 0, 0] mod 128) / 8) * 8.
// Only the window's channel 0 feeds an output (the Pallas bodies cut the
// product's columns to [:, :BH]), so only its 64 rows are read. The
// probe's arithmetic is its definition: the products are dense (the tent's
// zeros are multiplied like any other entry, the dots ramp is computed),
// the 64 columns are summed only after each product is complete, and the
// five products stay five products even where they are equal.
//
// Precision: the reference's products are Precision.HIGHEST, true float32.
// Here each is 3xTF32 on the tensor cores: both operands are split into a
// TF32 high part and a TF32 low part (round to nearest, ties away from
// zero, as cvt.rna rounds), and lo.hi + hi.lo + hi.hi is accumulated in
// float32 by mma.sync m16n8k8 (about 1e-6 of the output's scale against
// float32).
//
// What bounds it on this card: tensor-core operations. A product is 2 *
// 512 * 512 * 64 = 33.6 MFLOP, three TF32 passes each: a K4a / K4c step (5
// products) is 503 MFLOP, 1.017 us at 495 TFLOP/s, K4b (8) 1.627 us,
// against ~26 KB of coordinates and outputs a step (and the dma variant's
// 128 KB of window rows).
//
// Design:
// - Blocks are persistent (as many as fit the SMs, 384 threads each) and
//   walk the (step, sample slice) items, warp-specialized: a producer
//   warpgroup splits the window into TF32 hi / lo halves, two consumer
//   warpgroups take the products.
// - The window's channel 0 (64 x 512 floats) is resident in shared memory
//   for every step a block handles (the TPU keeps it in VMEM across steps:
//   its BlockSpec index map is constant), staged once a block with 16-byte
//   cp.async. The dma variant instead copies its 64 rows at oy for every
//   item, as its definition requires, through a 4-stage cp.async ring of
//   64-lane chunks that runs across items.
// - The producers split the window per item, chunk by chunk (64 lanes and
//   the 4 before them, for the roll), into a double buffer of hi and lo
//   halves; named barriers hand each buffer to the consumers and back, so
//   a split overlaps the products of the chunk before it. Rows padded to
//   68 words make a fragment load (8 rows x 4 lanes) hit 32 distinct banks.
// - A consumer builds A in registers, straight from the coordinates (tent
//   or ramp), in the m16n8k8 A-fragment layout, and splits it there;
//   nothing of A goes through shared memory. The roll is lane arithmetic
//   in B's addressing, (k - o * roll); `roll` is a kernel argument, so each
//   of the roll body's products loads its own B, and the other bodies'
//   five products share one load of B (their five mma chains stay five).
// - A consumer warp owns 16 samples x 32 columns of all five products
//   (K4a, K4c: 8 warps = 64 samples x 64 columns an item) or 32 samples x
//   64 columns of one lead (K4b: 256 samples an item; the producers split
//   each chunk once a lead).
// - The column sums come from the accumulator fragments: within the
//   thread, over the quad by shuffles, then across the warps of an item
//   through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BH = 64, BW = 512, PG = 512, NOX = 5, LEADS = 8;
constexpr int XROWS = 8;  // x's sublane-padded rows a step
constexpr int PRODUCERS = 128;  // warpgroup 0
constexpr int WARPS = 8;        // consumer warps (warpgroups 1, 2)
constexpr int CONSUMERS = 32 * WARPS;
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int WP = BW + 4;      // resident window row pitch (floats)
constexpr int KC = 64;          // lanes a chunk
constexpr int HALO = 4;         // lanes split before a chunk (roll <= 1)
constexpr int SP = KC + HALO;   // split row pitch (words): 68 = 4 mod 32
constexpr int NCH = BW / KC;    // chunks an item (a lead)
constexpr int STAGES = 4;       // dma ring depth
constexpr int RP = KC + 4;      // dma ring row pitch (floats)
constexpr int SPLIT_WORDS = BH * SP;  // one half of one buffer
// named barriers (0 is __syncthreads'): split buffer s full / empty, the
// producers' own, the consumers' own
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCERS = 5, BAR_CONSUMERS = 6;
enum { DOTS = 0, TENT = 1 };

// J products, a consumer warp tile of MT * 16 samples x NT * 8 columns
template <int J, int MT, int NT>
struct Tile {
  static constexpr int WN = BH / (8 * NT);           // warps across the columns
  static constexpr int ROWS = 16 * MT * WARPS / WN;  // samples an item
  static constexpr int SLICES = PG / ROWS;           // items a step
  static constexpr int RED = WN > 1 ? J * WN * ROWS : 0;  // floats
};

__device__ __forceinline__ float tent(float d) {
  const float a = -0.75f;
  float s = fabsf(d);
  float k01 = ((a + 2.0f) * s - (a + 3.0f)) * s * s + 1.0f;
  float k12 = ((a * s - 5.0f * a) * s + 8.0f * a) * s - 4.0f * a;
  return s < 1.0f ? k01 : (s < 2.0f ? k12 : 0.0f);
}

// a = hi + lo + O(2^-22 a), hi and lo TF32 values rounded to nearest,
// ties away from zero (cvt.rna's rounding). The mma reads a TF32 operand's
// top 19 bits, so adding half a TF32 ulp (0x1000) to a float's bits rounds
// it: one integer add where cvt.rna.tf32.f32 compiles to a compare and a
// select around it. a - hi is exact.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) + 0x1000u;
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// d += a . b, one 16 x 8 x 8 TF32 product (volatile: equal products of
// the five are not merged)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Producer: word c of each split row is lane k0 - HALO + c of the 64 rows
// (row pitch `pitch`; a lane below 0 wraps by `wrap`, a multiple of 4),
// split into the hi and lo halves of buffer `sb`, 4 lanes at a time.
__device__ __forceinline__ void split_chunk(const float* rows, int pitch,
                                            int k0, int wrap, uint32_t* sb) {
  constexpr int QUADS = SP / 4;
  for (int e = threadIdx.x; e < BH * QUADS; e += PRODUCERS) {
    const int h = e / QUADS, c = (e % QUADS) * 4;
    int k = k0 - HALO + c;
    k += k < 0 ? wrap : 0;
    const float4 v = *reinterpret_cast<const float4*>(rows + h * pitch + k);
    uint4 hi, lo;
    split(v.x, hi.x, lo.x);
    split(v.y, hi.y, lo.y);
    split(v.z, hi.z, lo.z);
    split(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(sb + h * SP + c) = hi;
    *reinterpret_cast<uint4*>(sb + SPLIT_WORDS + h * SP + c) = lo;
  }
}

// Producer: the split buffers for chunks 0 .. total - 1 from the resident
// window; chunk q is lanes [(q % NCH) * KC, + KC).
__device__ __forceinline__ void produce_resident(const float* ws,
                                                 uint32_t* split, int total) {
  for (int q = 0; q < total; ++q) {
    if (q >= 2) bar_sync(BAR_EMPTY + (q & 1), THREADS);  // chunk q - 2's
    split_chunk(ws, WP, (q % NCH) * KC, BW, split + (q & 1) * 2 * SPLIT_WORDS);
    bar_arrive(BAR_FULL + (q & 1), THREADS);
  }
  for (int q = total > 2 ? total : 2; q < total + 2; ++q)
    bar_sync(BAR_EMPTY + (q & 1), THREADS);  // the last two chunks'
}

// One k8 slice (lanes k .. k + 7) of the J products of this warp's tile.
// x[m][0], x[m][1]: the coordinates of the thread's rows g and g + 8 of
// m-tile m; b_at(j, nt, dk, hi, lo) loads the split window value of
// product j, column tile nt, at lane k + (lane & 3) + dk of column g.
template <int Build, int J, int MT, int NT, class BAt>
__device__ __forceinline__ void k8_step(float (&acc)[J][MT][NT][4],
                                        float (&x)[MT][2], float scale,
                                        int k, BAt b_at) {
  const int t = threadIdx.x & 3;
  const float k0 = (float)(k + t), k1 = (float)(k + t + 4);
  uint32_t ah[MT][4], al[MT][4];
  if (Build == TENT) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      split(tent(x[m][0] - k0), ah[m][0], al[m][0]);
      split(tent(x[m][1] - k0), ah[m][1], al[m][1]);
      split(tent(x[m][0] - k1), ah[m][2], al[m][2]);
      split(tent(x[m][1] - k1), ah[m][3], al[m][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (Build == DOTS) {  // every row of the ramp is the same
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        split(__fadd_rn(__fmul_rn(k0, scale), (float)j), ah[m][0], al[m][0]);
        split(__fadd_rn(__fmul_rn(k1, scale), (float)j), ah[m][2], al[m][2]);
        ah[m][1] = ah[m][0], al[m][1] = al[m][0];
        ah[m][3] = ah[m][2], al[m][3] = al[m][2];
      }
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b_at(j, nt, 0, bh[nt][0], bl[nt][0]);
      b_at(j, nt, 4, bh[nt][1], bl[nt][1]);
    }
    // pass-major: consecutive mma's feed independent accumulators
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma(acc[j][m][nt], al[m], bh[nt][0], bh[nt][1]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma(acc[j][m][nt], ah[m], bl[nt][0], bl[nt][1]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma(acc[j][m][nt], ah[m], bh[nt][0], bh[nt][1]);
  }
}

// Consumer: one chunk (KC lanes from k0) of the warp's products from
// split buffer `sb`; product j reads it j * roll lanes back.
template <int Build, int J, int MT, int NT>
__device__ __forceinline__ void consume_chunk(float (&acc)[J][MT][NT][4],
                                              float (&x)[MT][2], float scale,
                                              int k0, const uint32_t* sb,
                                              int roll) {
  using T = Tile<J, MT, NT>;
  const int c = threadIdx.x - PRODUCERS, lane = c & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* col = sb + (((c >> 5) % T::WN) * NT * 8 + g) * SP + HALO + t;
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 8)
    k8_step<Build>(acc, x, scale, k0 + kk,
                   [&](int j, int nt, int dk, uint32_t& hi, uint32_t& lo) {
                     const uint32_t* p = col + nt * 8 * SP + kk + dk - j * roll;
                     hi = p[0];
                     lo = p[SPLIT_WORDS];
                   });
}

// the coordinates of the consumer thread's rows in the item (x: the
// step's row of PG coordinates, row0: the item's first sample)
template <int J, int MT, int NT>
__device__ __forceinline__ void load_rows(float (&xr)[MT][2],
                                          const float* __restrict__ x,
                                          int row0) {
  using T = Tile<J, MT, NT>;
  const int c = threadIdx.x - PRODUCERS;
  const int warp = c >> 5, g = (c & 31) >> 2;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = row0 + ((warp / T::WN) * MT + m) * 16 + g;
    xr[m][0] = x[r];
    xr[m][1] = x[r + 8];
  }
}

// Each product complete: sum its 64 columns (within the thread, over the
// quad, then across the WN warps of the item through `red`) and write
// out[j * PG + row0 + r] for the item's rows r.
template <int J, int MT, int NT>
__device__ __forceinline__ void column_sums(float (&acc)[J][MT][NT][4],
                                            float* red, float* out,
                                            int row0) {
  using T = Tile<J, MT, NT>;
  const int c = threadIdx.x - PRODUCERS, lane = c & 31, warp = c >> 5;
  const int wn = warp % T::WN;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = ((warp / T::WN) * MT + m) * 16 + (lane >> 2);
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s0 += acc[j][m][nt][0] + acc[j][m][nt][1];
        s1 += acc[j][m][nt][2] + acc[j][m][nt][3];
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, d);
        s1 += __shfl_xor_sync(0xffffffffu, s1, d);
      }
      if ((lane & 3) == 0) {
        if (T::WN == 1) {
          out[j * PG + row0 + r] = s0;
          out[j * PG + row0 + r + 8] = s1;
        } else {
          red[(j * T::WN + wn) * T::ROWS + r] = s0;
          red[(j * T::WN + wn) * T::ROWS + r + 8] = s1;
        }
      }
    }
  if (T::WN > 1) {
    bar_sync(BAR_CONSUMERS, CONSUMERS);
    for (int e = c; e < J * T::ROWS; e += CONSUMERS) {
      const int j = e / T::ROWS, rr = e % T::ROWS;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < T::WN; ++w) s += red[(j * T::WN + w) * T::ROWS + rr];
      out[j * PG + row0 + rr] = s;
    }
    bar_sync(BAR_CONSUMERS, CONSUMERS);  // red is written again next item
  }
}

template <int J, int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[J][MT][NT][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][m][nt][i] = 0.0f;
}

// The window's channel 0 into shared memory (row pitch WP), once a block,
// by every thread.
__device__ __forceinline__ void stage_window(float* ws, const float* win) {
  for (int e = threadIdx.x; e < BH * BW / 4; e += THREADS) {
    const int h = e / (BW / 4), c = (e % (BW / 4)) * 4;
    cp_async16(ws + h * WP + c, win + h * BW + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// K4a, K4c: a consumer warp tile of 16 samples x 32 columns of the five
// products; K4b: 32 samples x the 64 columns of one lead
using TileX5 = Tile<NOX, 1, 4>;
using TileLead = Tile<1, 2, 8>;

// the block's items: blockIdx.x, + gridDim.x, ... below n_items
__device__ __forceinline__ int items_of_block(int n_items) {
  const int b = blockIdx.x, n = gridDim.x;
  return b < n_items ? (n_items - 1 - b) / n + 1 : 0;
}

// Roll: product j reads the window rolled by j * roll lanes; without it
// the five products read the same fragments, loaded once
template <int Build, bool Roll>
__global__ void __launch_bounds__(THREADS, 1)
    step_variant_kernel(const float* __restrict__ x,
                        const float* __restrict__ win, float* __restrict__ out,
                        int n_steps, int roll) {
  using T = TileX5;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  uint32_t* split = reinterpret_cast<uint32_t*>(smem + BH * WP);
  float* red = smem + BH * WP + 4 * SPLIT_WORDS;
  stage_window(ws, win);
  const int total = items_of_block(n_steps * T::SLICES) * NCH;
  if (threadIdx.x < PRODUCERS) {
    produce_resident(ws, split, total);
    return;
  }
  float acc[NOX][1][4][4];
  float xr[1][2];
  float scale = 0.0f;
  for (int q = 0; q < total; ++q) {
    const int item = blockIdx.x + (q / NCH) * gridDim.x, c = q % NCH;
    const int step = item / T::SLICES, row0 = (item % T::SLICES) * T::ROWS;
    const float* xs = x + (size_t)step * XROWS * PG;
    if (c == 0) {
      load_rows<NOX, 1, 4>(xr, xs, row0);
      scale = xs[0] * 1e-6f;
      zero(acc);
    }
    bar_sync(BAR_FULL + (q & 1), THREADS);
    consume_chunk<Build>(acc, xr, scale, c * KC,
                         split + (q & 1) * 2 * SPLIT_WORDS, Roll ? roll : 0);
    bar_arrive(BAR_EMPTY + (q & 1), THREADS);
    if (c == NCH - 1) column_sums(acc, red, out + (size_t)step * NOX * PG, row0);
  }
}

template <bool Unrolled>
__global__ void __launch_bounds__(THREADS, 1)
    step_dyn_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    float* __restrict__ out, int n_steps) {
  using T = TileLead;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  uint32_t* split = reinterpret_cast<uint32_t*>(smem + BH * WP);
  stage_window(ws, win);
  const int items = items_of_block(n_steps * T::SLICES);
  if (threadIdx.x < PRODUCERS) {
    produce_resident(ws, split, items * LEADS * NCH);  // a chunk a lead
    return;
  }
  for (int i = 0; i < items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int step = item / T::SLICES, row0 = (item % T::SLICES) * T::ROWS;
    const size_t base = (size_t)step * LEADS * PG;
    auto lead = [&](int l) {
      float xr[2][2];
      load_rows<1, 2, 8>(xr, x + base + l * PG, row0);
      float acc[1][2][8][4];
      zero(acc);
#pragma unroll 1
      for (int c = 0; c < NCH; ++c) {
        const int q = (i * LEADS + l) * NCH + c;
        bar_sync(BAR_FULL + (q & 1), THREADS);
        consume_chunk<TENT>(acc, xr, 0.0f, c * KC,
                            split + (q & 1) * 2 * SPLIT_WORDS, 0);
        bar_arrive(BAR_EMPTY + (q & 1), THREADS);
      }
      column_sums(acc, nullptr, out + base + l * PG, row0);
    };
    if (Unrolled) {
#pragma unroll
      for (int l = 0; l < LEADS; ++l) lead(l);
    } else {
#pragma unroll 1
      for (int l = 0; l < LEADS; ++l) lead(l);
    }
  }
}

__device__ __forceinline__ int dma_row(float x0, int big_rows) {
  float m = x0 - floorf(x0 / 128.0f) * 128.0f;  // jnp's floor mod
  int oy = ((int)m / 8) * 8;
  return oy < 0 ? 0 : (oy > big_rows - BH ? big_rows - BH : oy);
}

__global__ void __launch_bounds__(THREADS, 1)
    step_dma_kernel(const float* __restrict__ x, const float* __restrict__ big,
                    float* __restrict__ out, int n_steps, int big_rows) {
  using T = TileX5;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  uint32_t* split = reinterpret_cast<uint32_t*>(smem + STAGES * BH * RP);
  float* red = smem + STAGES * BH * RP + 4 * SPLIT_WORDS;
  const int total = items_of_block(n_steps * T::SLICES) * NCH;
  if (threadIdx.x < PRODUCERS) {
    // chunk q: lanes [(q % NCH) * KC, + KC) of the 64 rows at its step's
    // oy, into columns [0, KC) of ring stage q % STAGES
    auto copy = [&](int q) {
      if (q < total) {
        const int step = (blockIdx.x + (q / NCH) * gridDim.x) / T::SLICES;
        const int oy = dma_row(x[(size_t)step * XROWS * PG], big_rows);
        const float* src = big + (size_t)oy * BW + (q % NCH) * KC;
        float* dst = ring + (q % STAGES) * BH * RP;
        for (int e = threadIdx.x; e < BH * KC / 4; e += PRODUCERS) {
          const int h = e / (KC / 4), c = (e % (KC / 4)) * 4;
          cp_async16(dst + h * RP + c, src + (size_t)h * BW + c);
        }
      }
      cp_async_commit();  // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) copy(s);
    for (int q = 0; q < total; ++q) {
      cp_async_wait<STAGES - 2>();         // this thread's pieces of q
      bar_sync(BAR_PRODUCERS, PRODUCERS);  // everyone's; q - 1 is split
      copy(q + STAGES - 1);                // into the stage q - 1 used
      if (q >= 2) bar_sync(BAR_EMPTY + (q & 1), THREADS);
      // lanes 0 .. KC - 1 of the chunk are ring columns 0 .. KC - 1; the
      // halo wraps to the never-copied columns KC .. RP - 1, which no
      // consumer reads (the dma body has no roll)
      split_chunk(ring + (q % STAGES) * BH * RP, RP, 0, RP,
                  split + (q & 1) * 2 * SPLIT_WORDS);
      bar_arrive(BAR_FULL + (q & 1), THREADS);
    }
    for (int q = total > 2 ? total : 2; q < total + 2; ++q)
      bar_sync(BAR_EMPTY + (q & 1), THREADS);
    cp_async_wait<0>();
    return;
  }
  float acc[NOX][1][4][4];
  float xr[1][2];
  for (int q = 0; q < total; ++q) {
    const int item = blockIdx.x + (q / NCH) * gridDim.x, c = q % NCH;
    const int step = item / T::SLICES, row0 = (item % T::SLICES) * T::ROWS;
    if (c == 0) {
      load_rows<NOX, 1, 4>(xr, x + (size_t)step * XROWS * PG, row0);
      zero(acc);
    }
    bar_sync(BAR_FULL + (q & 1), THREADS);
    consume_chunk<TENT>(acc, xr, 0.0f, c * KC, split + (q & 1) * 2 * SPLIT_WORDS, 0);
    bar_arrive(BAR_EMPTY + (q & 1), THREADS);
    if (c == NCH - 1) column_sums(acc, red, out + (size_t)step * NOX * PG, row0);
  }
}

// Persistent grid: as many blocks as fit on the SMs, at most one an item.
template <class K>
cudaError_t prepare(K kernel, int smem, int items, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = items < most ? items : most;
  return cudaSuccess;
}

constexpr int SPLIT_BYTES = 2 * 2 * SPLIT_WORDS * 4;  // 2 buffers x (hi, lo)
constexpr int RESIDENT_SMEM = BH * WP * 4 + SPLIT_BYTES;
constexpr int VARIANT_SMEM = RESIDENT_SMEM + TileX5::RED * 4;
constexpr int DMA_SMEM = STAGES * BH * RP * 4 + SPLIT_BYTES + TileX5::RED * 4;

}  // namespace

// Plain C entry points (loaded with ctypes). Arrays are contiguous float32:
// x (n_steps, 8, 512) [dyn: (n_steps, 8, 512), one row a lead]; win (2, 64,
// 512); big (2, big_rows, 512); out (n_steps, 5 or 8, 512). Each launches on
// `stream` and returns the first CUDA error of its set-up or launch.
extern "C" int s360_step_variant(const float* x, const float* win, float* out,
                                 int n_steps, int body, void* stream) {
  if (n_steps <= 0 || n_steps > (1 << 24) || body < 0 || body > 2)
    return (int)cudaErrorInvalidValue;
  const int items = n_steps * TileX5::SLICES;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  cudaError_t err;
  if (body == 0) {
    err = prepare(step_variant_kernel<DOTS, false>, VARIANT_SMEM, items, &blocks);
    if (err != cudaSuccess) return (int)err;
    step_variant_kernel<DOTS, false><<<blocks, THREADS, VARIANT_SMEM, s>>>(
        x, win, out, n_steps, 0);
  } else if (body == 1) {
    err = prepare(step_variant_kernel<TENT, false>, VARIANT_SMEM, items, &blocks);
    if (err != cudaSuccess) return (int)err;
    step_variant_kernel<TENT, false><<<blocks, THREADS, VARIANT_SMEM, s>>>(
        x, win, out, n_steps, 0);
  } else {
    err = prepare(step_variant_kernel<TENT, true>, VARIANT_SMEM, items, &blocks);
    if (err != cudaSuccess) return (int)err;
    step_variant_kernel<TENT, true><<<blocks, THREADS, VARIANT_SMEM, s>>>(
        x, win, out, n_steps, 1);
  }
  return (int)cudaGetLastError();
}

extern "C" int s360_step_dyn(const float* x, const float* win, float* out,
                             int n_steps, int unrolled, void* stream) {
  if (n_steps <= 0 || n_steps > (1 << 24)) return (int)cudaErrorInvalidValue;
  const int items = n_steps * TileLead::SLICES;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  cudaError_t err;
  if (unrolled) {
    err = prepare(step_dyn_kernel<true>, RESIDENT_SMEM, items, &blocks);
    if (err != cudaSuccess) return (int)err;
    step_dyn_kernel<true><<<blocks, THREADS, RESIDENT_SMEM, s>>>(x, win, out,
                                                                 n_steps);
  } else {
    err = prepare(step_dyn_kernel<false>, RESIDENT_SMEM, items, &blocks);
    if (err != cudaSuccess) return (int)err;
    step_dyn_kernel<false><<<blocks, THREADS, RESIDENT_SMEM, s>>>(x, win, out,
                                                                  n_steps);
  }
  return (int)cudaGetLastError();
}

extern "C" int s360_step_dma(const float* x, const float* big, float* out,
                             int n_steps, int big_rows, void* stream) {
  if (n_steps <= 0 || n_steps > (1 << 24) || big_rows < BH)
    return (int)cudaErrorInvalidValue;
  const int items = n_steps * TileX5::SLICES;
  int blocks = 0;
  cudaError_t err = prepare(step_dma_kernel, DMA_SMEM, items, &blocks);
  if (err != cudaSuccess) return (int)err;
  step_dma_kernel<<<blocks, THREADS, DMA_SMEM, (cudaStream_t)stream>>>(
      x, big, out, n_steps, big_rows);
  return (int)cudaGetLastError();
}
