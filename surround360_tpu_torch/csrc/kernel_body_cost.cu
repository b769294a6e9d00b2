// The body-cost probe for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel of benchmarks/kernel_body_cost.py::main
// (`make_variant`, pallas_call :176): K1's non-offsets body at the 6k
// novel-view geometry, one grid step per sample group, with one component
// stubbed per variant. Geometry: C = 4 channels x BH = 72 window rows, the
// window BW = 384 lanes wide and cut to BWB = 256, PG = 512 samples a step.
//
// What a step computes (shifts (n,) int32; x, y (n, 1, PG); the window
// (C * BH, BW), or (C * BH + 64, BW) for full_dma):
//   1. ohx[p, k] = tent(x[p] - k), k < 256, and ohy[p, j] = tent(y[p] - j),
//      j < 72 (bicubic, a = -0.75); stubs: x[p] * 1e-3, y[p] * 1e-3;
//   2. wm[r, k] = win[r0 + r, (k - shift) mod 384] for k < 256 (jnp.roll
//      semantics; the no_roll stub takes shift 0; r0 = (step % 8) * 8 for
//      full_dma, else 0);
//   3. tmp = dot3(ohx, wm), (512 x 288): the reference's own product, both
//      operands split into bf16 hi and lo parts (round to nearest even, as
//      jnp's astype) and ah.bh + al.bh + ah.bl accumulated in float32;
//      stub: tmp[p, j] = x[p] * 1e-3 + ohx[p, 0];
//   4. out[step, c, p] = sum_{j < 72} tmp[p, c * 72 + j] * ohy[p, j]; stub:
//      tmp[p, c * 72] + ohy[p, 0].
// The product is dense: the tent's zeros are multiplied like any other
// entry.
//
// What bounds it on this card: tensor-core operations. The product is 2 *
// 512 * 256 * 288 = 75.5 MFLOP a step, three bf16 passes: 0.229 us at 989
// TFLOP/s, plus the 0.29 MFLOP reduction outside the tensor cores (0.004
// us at 67 TFLOP/s), against 12 KB of coordinates and outputs a step and
// the full_dma copy.
//
// Design:
// - Blocks are persistent (one an SM) and walk the (step, 128-sample
//   slice) items, warp-specialized: one producer warpgroup streams the
//   window, two consumer warpgroups take the products, and setmaxnreg
//   moves registers from the first (40 a thread) to the others (232). A
//   consumer warp owns 16 samples x all 288 product columns (36 n8 tiles,
//   144 accumulators a thread), so ohx is built once: in registers,
//   straight from the coordinates, in the m16n8k16 A-fragment layout, and
//   split there into bf16 hi / lo.
// - The window (288 x 384 floats, 442 KB) does not fit in shared memory.
//   The producers stream each item's rolled window in chunks of 32 lanes
//   through a 3-stage ring of 16-byte cp.async copies (the aligned 36
//   lanes around the chunk, wrapping at lane 384; full_dma's rows rotate
//   with the step), and split each chunk into bf16 hi / lo copies (in the
//   kernel and per step, as the reference's body splits its rolled, cut
//   window) in a double buffer whose 80-byte rows make the consumers'
//   ldmatrix.x4 loads of B's fragments free of bank conflicts. Named
//   barriers hand each buffer over (full: producers to consumers; empty:
//   back), so the copy and split of the next chunks overlap the products
//   and the epilogue; the ring runs across items.
// - The reduction runs on the accumulator fragments: 72 = 9 x 8, so an n8
//   tile never straddles a channel; each value is multiplied by its
//   tent(y[p] - j), computed in registers, summed within the thread, then
//   over the quad by shuffles.
// - no_dot has no product: at launch-latency scale, one thread a sample.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 4, BH = 72, BW = 384, BWB = 256, PG = 512;
constexpr int NJ = C * BH;            // 288 product columns
constexpr int NT = NJ / 8;            // 36 n8 tiles, 9 a channel
constexpr int TG = 2;                 // tiles loaded at a time
constexpr int PRODUCERS = 128;        // warpgroup 0
constexpr int CONSUMER_WARPS = 8;     // warpgroups 1 and 2
constexpr int THREADS = PRODUCERS + 32 * CONSUMER_WARPS;
// 384 threads launch with 168 registers each (3 warps a sub-partition);
// setmaxnreg then moves registers from the producers to the consumers
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(PRODUCERS * PRODUCER_REGS + (THREADS - PRODUCERS) * CONSUMER_REGS ==
                  THREADS * LAUNCH_REGS,
              "the consumers take what the producers give up");
constexpr int ROWS = 16 * CONSUMER_WARPS;  // samples an item
constexpr int SLICES = PG / ROWS;     // items a step
constexpr int KC = 32;                // lanes a chunk
constexpr int NCH = BWB / KC;         // chunks an item
constexpr int PIECES = KC / 4 + 1;    // 16-byte copies a row of a chunk
constexpr int RAWP = 4 * PIECES;      // raw ring row pitch (floats)
constexpr int STAGES = 3;             // raw ring depth
constexpr int SBP = KC + 8;           // split row pitch (bf16): 80 bytes
constexpr int RAW_BYTES = STAGES * NJ * RAWP * 4;
constexpr int SPLIT_BYTES = 2 * 2 * NJ * SBP * 2;  // 2 buffers x (hi, lo)
constexpr int SMEM = RAW_BYTES + SPLIT_BYTES;      // 216,576
// named barriers (0 is __syncthreads'): split buffer s full / empty, and
// the producers' own
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_RAW = 5;
enum { OHX = 1, OHY = 2, DOT = 4, REDUCE = 8, ROLL = 16, DMA = 32 };

__device__ __forceinline__ float tent(float d) {
  const float a = -0.75f;
  float s = fabsf(d);
  float k01 = ((a + 2.0f) * s - (a + 3.0f)) * s * s + 1.0f;
  float k12 = ((a * s - 5.0f * a) * s + 8.0f * a) * s - 4.0f * a;
  return s < 1.0f ? k01 : (s < 2.0f ? k12 : 0.0f);
}

// (v0, v1) = hi + lo, packed as bf16 pairs (v0 in the low half), each
// rounded to nearest even
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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

// Chunk q of a block's stream: lanes [(q % NCH) * KC, + KC) of item
// q / NCH's rolled window.
__device__ __forceinline__ int item_of(int q) {
  return blockIdx.x + (q / NCH) * gridDim.x;
}

// the window lane of chunk q's lane 0
template <int F>
__device__ __forceinline__ int first_of(int q, const int* __restrict__ shifts) {
  const int k0 = (q % NCH) * KC;
  if (!(F & ROLL)) return k0;
  const int f = (k0 - __ldg(shifts + item_of(q) / SLICES)) % BW;
  return f < 0 ? f + BW : f;
}

// Producer: chunk q's 288 rows x PIECES aligned 16-byte pieces into its
// raw stage. Lanes 0-26 of each producer warp copy 3 rows' pieces at a
// time (coalesced along the rows); the wrap at lane 384 is fixed a chunk.
constexpr int COPY_ROWS = 3 * PRODUCERS / 32;  // rows an iteration
template <int F>
__device__ __forceinline__ void copy_chunk(int q, int total, float* raw,
                                           const int* __restrict__ shifts,
                                           const float* __restrict__ win) {
  if (q < total) {
    const int lane = threadIdx.x & 31;
    if (lane < 3 * PIECES) {
      const int item = item_of(q);
      const int pc = lane % PIECES;
      int lane0 = (first_of<F>(q, shifts) & ~3) + 4 * pc;
      lane0 -= lane0 >= BW ? BW : 0;  // 384 = 96 pieces: none straddles
      const int r = (threadIdx.x >> 5) * 3 + lane / PIECES;
      const float* src = win + ((F & DMA) ? (size_t)(item / SLICES % 8) * 8 * BW : 0) +
                         (size_t)r * BW + lane0;
      float* dst = raw + (q % STAGES) * NJ * RAWP + r * RAWP + 4 * pc;
#pragma unroll 4
      for (int i = 0; i < NJ / COPY_ROWS; ++i)
        cp_async16(dst + i * COPY_ROWS * RAWP, src + (size_t)i * COPY_ROWS * BW);
    }
  }
  cp_async_commit();  // an empty group past the end keeps the count
}

// Producer: chunk q (raw stage, starting REM floats in) into bf16 hi / lo
// rows of the split buffer; a thread takes 4 lanes of 18 rows
template <int REM>
__device__ __forceinline__ void split_rows(const float* src, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  constexpr int RS = PRODUCERS / 8;  // rows an iteration
  const int m = threadIdx.x & 7, r0 = threadIdx.x >> 3;
#pragma unroll 2
  for (int i = 0; i < NJ / RS; ++i) {
    const int r = r0 + RS * i;
    const float4 a = *reinterpret_cast<const float4*>(src + r * RAWP + 4 * m);
    float v[4];
    if (REM == 0) {
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else {
      const float4 b = *reinterpret_cast<const float4*>(src + r * RAWP + 4 * m + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = w[REM + e];
    }
    uint2 h, l;
    split2(v[0], v[1], h.x, l.x);
    split2(v[2], v[3], h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * SBP + 4 * m) = h;
    *reinterpret_cast<uint2*>(lo + r * SBP + 4 * m) = l;
  }
}

template <int F>
__device__ __forceinline__ void split_chunk(int q, const float* raw,
                                            __nv_bfloat16* split,
                                            const int* __restrict__ shifts) {
  const float* src = raw + (q % STAGES) * NJ * RAWP;
  __nv_bfloat16* hi = split + (q & 1) * 2 * NJ * SBP;
  __nv_bfloat16* lo = hi + NJ * SBP;
  switch (first_of<F>(q, shifts) & 3) {  // uniform across the producers
    case 0: split_rows<0>(src, hi, lo); break;
    case 1: split_rows<1>(src, hi, lo); break;
    case 2: split_rows<2>(src, hi, lo); break;
    default: split_rows<3>(src, hi, lo); break;
  }
}

// keep: null in every launch. The store it guards keeps all 288 product
// columns live where no output reads them (no_reduce reads column c * 72):
// the reference's dot3 computes them all before its cut.
template <int F>
__global__ void __launch_bounds__(THREADS, 1)
    body_kernel(const int* __restrict__ shifts, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ win,
                float* __restrict__ out, int n_steps, float* keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  __nv_bfloat16* split = reinterpret_cast<__nv_bfloat16*>(smem + RAW_BYTES);
  const int n_items = n_steps * SLICES;
  const int mine =
      blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * NCH;  // chunks this block streams
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < PRODUCERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    copy_chunk<F>(0, total, raw, shifts, win);
    copy_chunk<F>(1, total, raw, shifts, win);
    for (int q = 0; q < total; ++q) {
      cp_async_wait<STAGES - 2>();  // this thread's pieces of chunk q
      bar_sync(BAR_RAW, PRODUCERS);  // everyone's; split q - 1 is done
      copy_chunk<F>(q + STAGES - 1, total, raw, shifts, win);
      if (q >= 2) bar_sync(BAR_EMPTY + (q & 1), THREADS);  // chunk q - 2's
      split_chunk<F>(q, raw, split, shifts);
      bar_arrive(BAR_FULL + (q & 1), THREADS);
    }
    for (int q = total > 2 ? total : 2; q < total + 2; ++q)
      bar_sync(BAR_EMPTY + (q & 1), THREADS);  // the last two chunks'
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = warp - PRODUCERS / 32, g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 rows: matrix m = lane / 8 (hi k0..7, hi k8..15, lo k0..7,
  // lo k8..15), row lane % 8 of the n8 tile
  const int lm = lane >> 3;
  const int lm_off = (lm >> 1) * NJ * SBP + (lane & 7) * SBP + (lm & 1) * 8;
  // the thread's rows g and g + 8 of item i
  auto row_of = [&](int item) {
    return (size_t)(item / SLICES) * PG + (item % SLICES) * ROWS + cw * 16 + g;
  };
  float acc[NT][4];
  float xa = 0.0f, xb = 0.0f, ya = 0.0f, yb = 0.0f;
  float nxa = 0.0f, nxb = 0.0f;  // the next item's, loaded an item ahead
  if (total > 0) nxa = xs[row_of(blockIdx.x)], nxb = xs[row_of(blockIdx.x) + 8];
  for (int q = 0; q < total; ++q) {
    const int c = q % NCH;
    if (c == 0) {
      const int item = item_of(q);
      xa = nxa, xb = nxb;
      ya = ys[row_of(item)], yb = ys[row_of(item) + 8];
      if (q + NCH < total) {
        nxa = xs[row_of(item + gridDim.x)];
        nxb = xs[row_of(item + gridDim.x) + 8];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    }
    bar_sync(BAR_FULL + (q & 1), THREADS);
    const __nv_bfloat16* sb = split + (q & 1) * 2 * NJ * SBP;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t ah[4], al[4];
      const float k0 = (float)(c * KC + kk + 2 * t);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // a0: (g, +0 +1), a1: (g + 8, ..), a2, a3: +8
        const float xv = (i >> 1) & 1 ? xb : xa;
        const float kf = k0 + (float)((i & 1) + ((i >> 2) << 3));
        v[i] = (F & OHX) ? tent(xv - kf) : xv * 1e-3f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split2(v[2 * i], v[2 * i + 1], ah[i], al[i]);
      // groups of TG tiles, pass-major: consecutive mma's feed
      // independent accumulators
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += TG) {
        uint32_t b[TG][4];  // bh0, bh1, bl0, bl1
#pragma unroll
        for (int i = 0; i < TG; ++i)
          ldmatrix_x4(b[i], sb + lm_off + (n0 + i) * 8 * SBP + kk);
#pragma unroll
        for (int i = 0; i < TG; ++i) mma(acc[n0 + i], ah, b[i][0], b[i][1]);
#pragma unroll
        for (int i = 0; i < TG; ++i) mma(acc[n0 + i], al, b[i][0], b[i][1]);
#pragma unroll
        for (int i = 0; i < TG; ++i) mma(acc[n0 + i], ah, b[i][2], b[i][3]);
      }
    }
    bar_arrive(BAR_EMPTY + (q & 1), THREADS);

    if (c == NCH - 1) {  // the item's products are complete: reduce
      const int item = item_of(q);
      float* o = out + (size_t)(item / SLICES) * C * PG + (item % SLICES) * ROWS +
                 cw * 16 + g;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        float s0, s1;
        if (F & REDUCE) {
          s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int n = 0; n < BH / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float j = (float)(n * 8 + 2 * t + e);
              const float wa = (F & OHY) ? tent(ya - j) : ya * 1e-3f;
              const float wb = (F & OHY) ? tent(yb - j) : yb * 1e-3f;
              s0 += acc[ch * 9 + n][e] * wa;
              s1 += acc[ch * 9 + n][2 + e] * wb;
            }
          }
#pragma unroll
          for (int m = 1; m < 4; m <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, m);
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
          }
        } else {  // column c * 72 (tile ch * 9, held by t == 0) + ohy[p, 0]
          s0 = acc[ch * 9][0] + ((F & OHY) ? tent(ya) : ya * 1e-3f);
          s1 = acc[ch * 9][2] + ((F & OHY) ? tent(yb) : yb * 1e-3f);
        }
        if (t == 0) {
          o[ch * PG] = s0;
          o[ch * PG + 8] = s1;
        }
      }
      if (!(F & REDUCE) && keep != nullptr) {
        float s = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          s += (acc[nt][0] + acc[nt][1]) + (acc[nt][2] + acc[nt][3]);
        keep[blockIdx.x * THREADS + threadIdx.x] = s;
      }
    }
  }
}

// no_dot: tmp[p, j] = x[p] * 1e-3 + ohx[p, 0] for every j, then the
// channel reduction against ohy
__global__ void __launch_bounds__(256)
    body_nodot_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys, float* __restrict__ out,
                      int n_steps) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n_steps * PG) return;
  const int step = i / PG, p = i % PG;
  const float x = xs[i], y = ys[i];
  const float tmp = x * 1e-3f + tent(x);
#pragma unroll 1
  for (int ch = 0; ch < C; ++ch) {
    float s = 0.0f;
    for (int j = 0; j < BH; ++j) s += tmp * tent(y - (float)j);
    out[((size_t)step * C + ch) * PG + p] = s;
  }
}

using Kernel = void (*)(const int*, const float*, const float*, const float*,
                        float*, int, float*);

}  // namespace

// Plain C entry point (loaded with ctypes). variant: 0 full, 1 no_ohx, 2
// no_ohy, 3 no_dot, 4 no_reduce, 5 no_roll, 6 full_dma. Arrays are
// contiguous: shifts (n_steps,) int32; xs, ys (n_steps, 1, 512) f32; win
// (win_rows, 384) f32 with win_rows >= 288 (>= 344 for full_dma); out
// (n_steps, 4, 512) f32. Launches on `stream` and returns the first CUDA
// error of its set-up or launch.
extern "C" int s360_body_cost(const int* shifts, const float* xs,
                              const float* ys, const float* win, float* out,
                              int n_steps, int win_rows, int variant,
                              void* stream) {
  constexpr int ALL = OHX | OHY | DOT | REDUCE | ROLL;
  static const Kernel kernels[7] = {
      body_kernel<ALL>,           body_kernel<ALL & ~OHX>,
      body_kernel<ALL & ~OHY>,    nullptr,
      body_kernel<ALL & ~REDUCE>, body_kernel<ALL & ~ROLL>,
      body_kernel<ALL | DMA>};
  if (n_steps <= 0 || n_steps > (1 << 21) || variant < 0 || variant > 6 ||
      win_rows < NJ + (variant == 6 ? 56 : 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 3) {
    body_nodot_kernel<<<(n_steps * PG + 255) / 256, 256, 0, s>>>(
        xs, ys, out, n_steps);
    return (int)cudaGetLastError();
  }
  const Kernel k = kernels[variant];
  // setmaxnreg.inc waits for registers that the producers' dec releases:
  // the launch must hold exactly the registers the static_assert counts
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err == cudaSuccess && attr.numRegs != LAUNCH_REGS)
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int items = n_steps * SLICES;
  k<<<items < sms ? items : sms, THREADS, SMEM, s>>>(shifts, xs, ys, win, out,
                                                    n_steps, nullptr);
  return (int)cudaGetLastError();
}
