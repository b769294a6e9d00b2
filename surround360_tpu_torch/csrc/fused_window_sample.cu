// Fused windowed resampling for Hopper (sm_90a): K1.
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
//   [sy[t, l], sy[t, l] + bh) x [sx[t, l], sx[t, l] + wx)
// and inside the array. Borders: "constant" weighs taps outside the window
// 0 (the padding is zero); "clamp" + bilinear clamps the coordinate to the
// source, "clamp" + bicubic clamps each tap to the source, before the
// window test. The TPU kernel builds the same weights as a distance kernel
// over the window's columns and contracts them on the MXU; the Keys weight
// is zero for |s| >= 2, so evaluating the taps directly gives the same sum.
//
// What bounds it on this card: device-memory bytes, on paper. A sample
// moves 8 B of coordinates and 4 C B of output, and its source pixels are
// shared with its neighbours; at C = 4 it does ~214 FLOPs, so at 3.35 TB/s
// against 67 TFLOP/s float32 the bytes set the bound (chip_smoke.py prints
// it per call). The first design read 16 taps x C scalar values per sample
// from L1/L2 (64 loads at C = 4, the channels Hp * Wp apart) and every
// warp pulled its own taps: load issue and cache traffic set its time.
//
// What this design does about it (window_common.cuh): each block stages
// the taps it needs once into shared memory, channel-interleaved, so a
// tap is one 16-byte shared load at C = 4 (16 a sample instead of 64
// global ones), and writes its outputs once, coalesced along p. What is
// left is the copy into shared memory and the arithmetic of the taps, not
// device memory: so a block whose samples cross the source on a slant or
// an arc stages only each row's span, interior samples take an unmasked
// path, and small tiles take small blocks, 8 an SM, whose phases overlap.

#include "window_common.cuh"

// Plain C entry point (loaded with ctypes). Arrays are contiguous:
// padded (L, C, Hp, Wp) f32; sy, sx (T, L) int32; xt, yt (T, L, P) f32;
// out (T, L, C, P) f32. Launches on `stream` and returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue when one window row of C
// channels exceeds a block's shared memory.
extern "C" int s360_fused_window_sample(
    const float* padded, const int* sy, const int* sx, const float* xt,
    const float* yt, float* out, int T, int L, int C, int Hp, int Wp, int P,
    int bh, int wx, int pad_y, int pad_x, int n_y, int n_x, int bicubic,
    int clamp, void* stream) {
  return s360::launch_window_sample<false>(
      padded, sy, sx, xt, yt, out, T, L, C, Hp, Wp, P, bh, wx, pad_y, pad_x,
      n_y, n_x, bicubic != 0, clamp != 0, (cudaStream_t)stream);
}
