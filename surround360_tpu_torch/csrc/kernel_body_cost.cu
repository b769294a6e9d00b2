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
//   3. tmp = ohx @ wm^T, (512 x 288), in float32 (the TPU's 3-pass bf16
//      `dot3` is its emulation of one float32 product); stub: tmp[p, j] =
//      x[p] * 1e-3 + ohx[p, 0];
//   4. out[step, c, p] = sum_{j < 72} tmp[p, c * 72 + j] * ohy[p, j]; stub:
//      tmp[p, c * 72] + ohy[p, 0].
// Work that feeds no output is skipped: no_dot builds only ohx's column 0
// and stages no window.
//
// What bounds it on this card: float32 operations. The product is 2 * 512
// * 256 * 288 = 75.5 MFLOP a step (1.13 us at 67 TFLOP/s) against 12 KB of
// coordinates and outputs and the 442 KB full_dma copy. The product is
// dense: the tent's zeros are multiplied like any other entry.
//
// Design (simple first): one block of 256 threads per (64-sample slice,
// step), which computes all 288 product columns of its samples, so ohx and
// ohy are built once a step. It walks the 256 lanes in chunks of 16: per
// chunk it builds its slice of ohx in shared memory while cp.async copies
// the chunk of all 288 window rows, rolled by an index shift, into shared
// memory (the TPU's `make_async_copy` into VMEM); each thread then
// accumulates 8 samples x 9 columns in registers. The channel reduction
// multiplies each thread's columns by ohy (staged once) and sums over the
// warp. The whole window (288 x 256 floats, 295 KB) would not fit a
// block's 227 KB of shared memory; a chunk takes 18.5 KB.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 4, BH = 72, BW = 384, BWB = 256, PG = 512;
constexpr int NJ = C * BH;   // 288 product columns
constexpr int NJP = NJ + 1;  // staged window row pitch (floats)
constexpr int JT = NJ / 32;  // 9 columns a thread
constexpr int ROWS = 64;     // samples a block
constexpr int RT = 8;        // samples a thread
constexpr int KC = 16;       // lanes a chunk
constexpr int THREADS = 256;
enum { OHX = 1, OHY = 2, DOT = 4, REDUCE = 8, ROLL = 16, DMA = 32 };

__device__ __forceinline__ float tent(float d) {
  const float a = -0.75f;
  float s = fabsf(d);
  float k01 = ((a + 2.0f) * s - (a + 3.0f)) * s * s + 1.0f;
  float k12 = ((a * s - 5.0f * a) * s + 8.0f * a) * s - 4.0f * a;
  return s < 1.0f ? k01 : (s < 2.0f ? k12 : 0.0f);
}

template <int F>
__global__ void __launch_bounds__(THREADS)
    body_kernel(const int* __restrict__ shifts, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ win,
                float* __restrict__ out) {
  __shared__ __align__(16) float As[KC * ROWS];
  __shared__ float Bs[KC * NJP];
  __shared__ float Ys[ROWS * BH];
  const int step = blockIdx.y, row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, tr = tid >> 5, tc = tid & 31;
  const float* x = xs + (size_t)step * PG + row0;
  const float* y = ys + (size_t)step * PG + row0;

  for (int e = tid; e < ROWS * BH; e += THREADS) {
    int r = e / BH, j = e % BH;
    Ys[e] = (F & OHY) ? tent(y[r] - (float)j) : y[r] * 1e-3f;
  }

  float acc[RT][JT];
  if (F & DOT) {
    const int shift = (F & ROLL) ? shifts[step] : 0;
    const float* w = win + ((F & DMA) ? (size_t)(step % 8) * 8 * BW : 0);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < JT; ++q) acc[i][q] = 0.0f;
    for (int k0 = 0; k0 < BWB; k0 += KC) {
      for (int e = tid; e < KC * NJ; e += THREADS) {
        int kk = e % KC, j = e / KC;
        int k = (k0 + kk - shift) % BW;
        k += k < 0 ? BW : 0;
        __pipeline_memcpy_async(&Bs[kk * NJP + j], &w[(size_t)j * BW + k], 4);
      }
      __pipeline_commit();
      for (int e = tid; e < KC * ROWS; e += THREADS) {
        int r = e % ROWS, kk = e / ROWS;
        As[kk * ROWS + r] =
            (F & OHX) ? tent(x[r] - (float)(k0 + kk)) : x[r] * 1e-3f;
      }
      __pipeline_wait_prior(0);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < KC; ++kk) {
        float4 a0 = *reinterpret_cast<const float4*>(&As[kk * ROWS + tr * RT]);
        float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk * ROWS + tr * RT + 4]);
        float av[RT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int q = 0; q < JT; ++q) {
          float b = Bs[kk * NJP + tc + 32 * q];
#pragma unroll
          for (int i = 0; i < RT; ++i) acc[i][q] = fmaf(av[i], b, acc[i][q]);
        }
      }
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float xv = x[tr * RT + i];
      float ohx0 = (F & OHX) ? tent(xv) : xv * 1e-3f;
      float t = xv * 1e-3f + ohx0;
#pragma unroll
      for (int q = 0; q < JT; ++q) acc[i][q] = t;
    }
    __syncthreads();  // Ys (the product path's first chunk barrier covers it)
  }

  float* o = out + (size_t)step * C * PG + row0 + tr * RT;
  if (F & REDUCE) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float* yr = &Ys[(tr * RT + i) * BH];
      float part[C] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < JT; ++q) {
        int j = tc + 32 * q;
        float v = acc[i][q] * yr[j % BH];
        // column j belongs to channel j / 72
#pragma unroll
        for (int c = 0; c < C; ++c) part[c] += (j / BH == c) ? v : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float s = part[c];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (tc == 0) o[c * PG + i] = s;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < JT; ++q) {
      int j = tc + 32 * q;
      if (j % BH == 0) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
          o[(j / BH) * PG + i] = acc[i][q] + Ys[(tr * RT + i) * BH];
      }
    }
  }
}

using Launch = void (*)(const int*, const float*, const float*, const float*,
                        float*);

}  // namespace

// Plain C entry point (loaded with ctypes). variant: 0 full, 1 no_ohx, 2
// no_ohy, 3 no_dot, 4 no_reduce, 5 no_roll, 6 full_dma. Arrays are
// contiguous: shifts (n_steps,) int32 in [0, 384); xs, ys (n_steps, 1, 512)
// f32; win (win_rows, 384) f32 with win_rows >= 288 (>= 344 for full_dma);
// out (n_steps, 4, 512) f32. Launches on `stream` and returns the launch's
// cudaGetLastError().
extern "C" int s360_body_cost(const int* shifts, const float* xs,
                              const float* ys, const float* win, float* out,
                              int n_steps, int win_rows, int variant,
                              void* stream) {
  constexpr int ALL = OHX | OHY | DOT | REDUCE | ROLL;
  static const Launch kernels[7] = {
      body_kernel<ALL>,          body_kernel<ALL & ~OHX>,
      body_kernel<ALL & ~OHY>,   body_kernel<ALL & ~DOT>,
      body_kernel<ALL & ~REDUCE>, body_kernel<ALL & ~ROLL>,
      body_kernel<ALL | DMA>};
  if (n_steps <= 0 || n_steps > 65535 || variant < 0 || variant > 6 ||
      win_rows < NJ + (variant == 6 ? 56 : 0))
    return (int)cudaErrorInvalidValue;
  dim3 grid(PG / ROWS, n_steps);
  kernels[variant]<<<grid, THREADS, 0, (cudaStream_t)stream>>>(shifts, xs, ys,
                                                              win, out);
  return (int)cudaGetLastError();
}
