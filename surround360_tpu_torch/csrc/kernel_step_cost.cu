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
// product's columns to [:, :BH]), so only its 64 rows are read.
//
// What bounds it on this card: float32 operations. A product is 2 * 512 *
// 512 * 64 = 33.6 MFLOP, five a step (168 MFLOP, 2.50 us at 67 TFLOP/s)
// against ~26 KB of coordinates and outputs a step. The probe's arithmetic
// is its definition: the products are dense (the tent's zeros are
// multiplied like any other entry) and the 64 columns are summed only
// after each product is complete.
//
// Design (simple first): one block of 256 threads per (64-row slice of
// the samples, step); the block walks the 512 lanes in chunks of 32. Per
// chunk it builds its slice of A in shared memory while cp.async copies
// the window's chunk (and the 4 lanes before it, for the roll) into shared
// memory, then each thread accumulates a 4-row x 4-column tile of each
// product in registers. The roll is an index shift into the staged chunk.
// `roll` is a kernel argument, so the five products of the tent body stay
// five products. The TPU's `make_async_copy` into VMEM is the per-chunk
// cp.async here; in the dma kernel its source rows depend on the step.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int BH = 64, BW = 512, PG = 512, NOX = 5, LEADS = 8;
constexpr int XROWS = 8;     // x's sublane-padded rows a step
constexpr int ROWS = 64;     // samples a block
constexpr int KC = 32;       // lanes a chunk
constexpr int HALO = NOX - 1;  // lanes staged before a chunk (the roll)
constexpr int BP = BH + 4;   // staged window row pitch (floats)
constexpr int THREADS = 256;
enum { DOTS = 0, TENT = 1 };

__device__ __forceinline__ float tent(float d) {
  const float a = -0.75f;
  float s = fabsf(d);
  float k01 = ((a + 2.0f) * s - (a + 3.0f)) * s * s + 1.0f;
  float k12 = ((a * s - 5.0f * a) * s + 8.0f * a) * s - 4.0f * a;
  return s < 1.0f ? k01 : (s < 2.0f ? k12 : 0.0f);
}

// J products of this block's 64 samples against the 64 window rows at
// w0 (row pitch BW); product j reads the window shifted by j * roll lanes
// and, for DOTS, adds j to A. Writes out[j * PG + p] for the block's p.
template <int Build, int J>
__device__ __forceinline__ void products(const float* __restrict__ xs,
                                         float scale,
                                         const float* __restrict__ w0,
                                         int roll, float* __restrict__ out,
                                         int row0) {
  __shared__ __align__(16) float As[KC * ROWS];
  __shared__ __align__(16) float Bs[(KC + HALO) * BP];
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  float acc[J][4][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][i][q] = 0.0f;

  for (int k0 = 0; k0 < BW; k0 += KC) {
    for (int e = tid; e < (KC + HALO) * BH; e += THREADS) {
      int kk = e % (KC + HALO), h = e / (KC + HALO);
      int k = (k0 - HALO + kk + BW) & (BW - 1);
      __pipeline_memcpy_async(&Bs[kk * BP + h], &w0[h * BW + k], 4);
    }
    __pipeline_commit();
    for (int e = tid; e < KC * ROWS; e += THREADS) {
      int r = e % ROWS, kk = e / ROWS;
      float kf = (float)(k0 + kk);
      As[kk * ROWS + r] = Build == DOTS ? kf * scale : tent(xs[row0 + r] - kf);
    }
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&As[kk * ROWS + tr * 4]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float4 b4 = *reinterpret_cast<const float4*>(
            &Bs[(kk + HALO - j * roll) * BP + tc * 4]);
        float av[4] = {a4.x, a4.y, a4.z, a4.w};
        float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float ai = Build == DOTS ? av[i] + (float)j : av[i];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][i][q] = fmaf(ai, bv[q], acc[j][i][q]);
        }
      }
    }
    __syncthreads();
  }
  // each product complete: sum its 64 columns (4 a thread, 16 lanes)
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = (acc[j][i][0] + acc[j][i][1]) + (acc[j][i][2] + acc[j][i][3]);
#pragma unroll
      for (int m = 8; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (tc == 0) out[j * PG + row0 + tr * 4 + i] = s;
    }
}

template <int Build>
__global__ void __launch_bounds__(THREADS)
    step_variant_kernel(const float* __restrict__ x,
                        const float* __restrict__ win, float* __restrict__ out,
                        int roll) {
  const int step = blockIdx.y, row0 = blockIdx.x * ROWS;
  const float* xs = x + (size_t)step * XROWS * PG;
  products<Build, NOX>(xs, xs[0] * 1e-6f, win, roll,
                       out + (size_t)step * NOX * PG, row0);
}

template <bool Unrolled>
__global__ void __launch_bounds__(THREADS)
    step_dyn_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    float* __restrict__ out) {
  const int step = blockIdx.y, row0 = blockIdx.x * ROWS;
  if (Unrolled) {
#pragma unroll
    for (int l = 0; l < LEADS; ++l)
      products<TENT, 1>(x + ((size_t)step * LEADS + l) * PG, 0.0f, win, 0,
                        out + ((size_t)step * LEADS + l) * PG, row0);
  } else {
#pragma unroll 1
    for (int l = 0; l < LEADS; ++l)
      products<TENT, 1>(x + ((size_t)step * LEADS + l) * PG, 0.0f, win, 0,
                        out + ((size_t)step * LEADS + l) * PG, row0);
  }
}

__global__ void __launch_bounds__(THREADS)
    step_dma_kernel(const float* __restrict__ x, const float* __restrict__ big,
                    float* __restrict__ out, int big_rows, int roll) {
  const int step = blockIdx.y, row0 = blockIdx.x * ROWS;
  const float* xs = x + (size_t)step * XROWS * PG;
  float x0 = xs[0];
  float m = x0 - floorf(x0 / 128.0f) * 128.0f;  // jnp's floor mod
  int oy = ((int)m / 8) * 8;
  oy = oy < 0 ? 0 : (oy > big_rows - BH ? big_rows - BH : oy);
  products<TENT, NOX>(xs, 0.0f, big + (size_t)oy * BW, roll,
                      out + (size_t)step * NOX * PG, row0);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Arrays are contiguous float32:
// x (n_steps, 8, 512) [dyn: (n_steps, 8, 512), one row a lead]; win (2, 64,
// 512); big (2, big_rows, 512); out (n_steps, 5 or 8, 512). Each launches on
// `stream` and returns the launch's cudaGetLastError().
extern "C" int s360_step_variant(const float* x, const float* win, float* out,
                                 int n_steps, int body, void* stream) {
  if (n_steps <= 0 || n_steps > 65535 || body < 0 || body > 2)
    return (int)cudaErrorInvalidValue;
  dim3 grid(PG / ROWS, n_steps);
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 0)
    step_variant_kernel<DOTS><<<grid, THREADS, 0, s>>>(x, win, out, 0);
  else
    step_variant_kernel<TENT><<<grid, THREADS, 0, s>>>(x, win, out, body == 2);
  return (int)cudaGetLastError();
}

extern "C" int s360_step_dyn(const float* x, const float* win, float* out,
                             int n_steps, int unrolled, void* stream) {
  if (n_steps <= 0 || n_steps > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(PG / ROWS, n_steps);
  cudaStream_t s = (cudaStream_t)stream;
  if (unrolled)
    step_dyn_kernel<true><<<grid, THREADS, 0, s>>>(x, win, out);
  else
    step_dyn_kernel<false><<<grid, THREADS, 0, s>>>(x, win, out);
  return (int)cudaGetLastError();
}

extern "C" int s360_step_dma(const float* x, const float* big, float* out,
                             int n_steps, int big_rows, void* stream) {
  if (n_steps <= 0 || n_steps > 65535 || big_rows < BH)
    return (int)cudaErrorInvalidValue;
  dim3 grid(PG / ROWS, n_steps);
  step_dma_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, big, out,
                                                              big_rows, 0);
  return (int)cudaGetLastError();
}
