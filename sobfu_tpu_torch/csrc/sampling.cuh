// Shared device helpers of the sobfu_tpu_torch kernels: voxel indexing, the
// exact and K-clamped trilinear samplers, the floor-corner rule, and the
// block-wide max and fixed-order sums.
//
// Layouts follow the JAX package: volumes f32[Z,Y,X] with the flat index
// (z*Y + y)*X + x (the reference's get_global_idx multiplies by dim_y*dim_y,
// which only a cubic grid hides); fields f32[3,Z,Y,X], channels (x, y, z),
// absolute voxel coordinates.
//
// Every file is compiled with --fmad=false: a*b + c stays a rounded multiply
// and a rounded add, as in the plain torch versions the kernels are checked
// against (the floor warp and the fuse must match them bit for bit). Where a
// plain version itself rounds once (torch.addcmul in the fuse), the kernel
// says so with __fmaf_rn.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sobfu {

constexpr int kBlock = 256;

inline int blocks_for(long long n) { return (int)((n + kBlock - 1) / kBlock); }

__device__ __forceinline__ long long flat_index(int x, int y, int z, int Y, int X) {
  return ((long long)z * Y + y) * X + x;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One axis of a trilinear sample.
//   exact (K < 0): i0 = floor(c), i1 = min(i0 + 1, n - 1), w1 = c - floor(c)
//     (fields._corner_indices), blended as c0 + (c1 - c0) * w1;
//   window (K >= 0): the displacement d = clip(c) - v is clamped to
//     [-K, hi] (hi = K - 1e-4) and the two live taps o0 = floor(d), o0 + 1
//     carry the hat weights max(0, 1 - |d - o|) (fields._window_taps).
struct AxisTaps {
  int i0, i1;
  float w0, w1;
};

// kExact is K < 0 as a compile-time constant (K and hi are then unused).
template <bool kExact>
__device__ __forceinline__ AxisTaps axis_taps_t(float c, int v, int n, int K, float hi) {
  AxisTaps t;
  c = clampf(c, 0.0f, (float)(n - 1));
  if (kExact) {
    const float f0 = floorf(c);
    t.i0 = (int)f0;
    t.i1 = min(t.i0 + 1, n - 1);
    t.w0 = 0.0f;
    t.w1 = c - f0;
  } else {
    const float d = clampf(c - (float)v, (float)(-K), hi);
    const float o0 = floorf(d);
    const float o1 = o0 + 1.0f;
    t.w0 = fmaxf(0.0f, 1.0f - fabsf(d - o0));
    t.w1 = fmaxf(0.0f, 1.0f - fabsf(d - o1));
    t.i0 = min(max(v + (int)o0, 0), n - 1);
    t.i1 = min(max(v + (int)o1, 0), n - 1);
  }
  return t;
}

__device__ __forceinline__ AxisTaps axis_taps(float c, int v, int n, int K, float hi) {
  return K < 0 ? axis_taps_t<true>(c, v, n, K, hi) : axis_taps_t<false>(c, v, n, K, hi);
}

struct Taps3 {
  AxisTaps x, y, z;
};

template <bool kExact>
__device__ __forceinline__ Taps3 taps3_t(float px, float py, float pz, int vx, int vy, int vz,
                                         int Z, int Y, int X, int K, float hi) {
  Taps3 t;
  t.x = axis_taps_t<kExact>(px, vx, X, K, hi);
  t.y = axis_taps_t<kExact>(py, vy, Y, K, hi);
  t.z = axis_taps_t<kExact>(pz, vz, Z, K, hi);
  return t;
}

__device__ __forceinline__ Taps3 taps3(float px, float py, float pz, int vx, int vy,
                                       int vz, int Z, int Y, int X, int K, float hi) {
  Taps3 t;
  t.x = axis_taps(px, vx, X, K, hi);
  t.y = axis_taps(py, vy, Y, K, hi);
  t.z = axis_taps(pz, vz, Z, K, hi);
  return t;
}

// The blend of a trilinear sample from its 8 corner values, c[a + 2b + 4c]
// the corner at x tap a, y tap b, z tap c. The summation order is the plain
// version's: x taps inside, then y, then z.
__device__ __forceinline__ float blend8(const Taps3& t, bool exact, const float (&c)[8]) {
  if (exact) {
    const float fx = t.x.w1, fy = t.y.w1, fz = t.z.w1;
    const float c00 = c[0] + (c[1] - c[0]) * fx;
    const float c10 = c[2] + (c[3] - c[2]) * fx;
    const float c01 = c[4] + (c[5] - c[4]) * fx;
    const float c11 = c[6] + (c[7] - c[6]) * fx;
    const float c0 = c00 + (c10 - c00) * fy;
    const float c1 = c01 + (c11 - c01) * fy;
    return c0 + (c1 - c0) * fz;
  }
  const float a00 = t.x.w0 * c[0] + t.x.w1 * c[1];
  const float a10 = t.x.w0 * c[2] + t.x.w1 * c[3];
  const float a01 = t.x.w0 * c[4] + t.x.w1 * c[5];
  const float a11 = t.x.w0 * c[6] + t.x.w1 * c[7];
  const float b0 = t.y.w0 * a00 + t.y.w1 * a10;
  const float b1 = t.y.w0 * a01 + t.y.w1 * a11;
  return t.z.w0 * b0 + t.z.w1 * b1;
}

// The flat offsets of the 8 corners in a volume of rows X wide and planes
// Y rows deep, in blend8's order.
__device__ __forceinline__ void corner_offsets(const Taps3& t, int Y, int X, int (&o)[8]) {
  const int r00 = (t.z.i0 * Y + t.y.i0) * X, r10 = (t.z.i0 * Y + t.y.i1) * X;
  const int r01 = (t.z.i1 * Y + t.y.i0) * X, r11 = (t.z.i1 * Y + t.y.i1) * X;
  o[0] = r00 + t.x.i0; o[1] = r00 + t.x.i1; o[2] = r10 + t.x.i0; o[3] = r10 + t.x.i1;
  o[4] = r01 + t.x.i0; o[5] = r01 + t.x.i1; o[6] = r11 + t.x.i0; o[7] = r11 + t.x.i1;
}

// Trilinear sample through a corner getter g(x, y, z), in blend8's order.
// It keeps its own copy of the blend: A's and E's march (gd_step.cuh) call
// it, and with the corners first gathered into an array for blend8 the
// compiler schedules A's march differently, 3.5-6% slower at 128^3
// (chip_smoke.py --probe's compositive frame profiles on an H100).
template <typename Get>
__device__ __forceinline__ float trilinear(const Taps3& t, bool exact, Get g) {
  if (exact) {
    const float fx = t.x.w1, fy = t.y.w1, fz = t.z.w1;
    const float c000 = g(t.x.i0, t.y.i0, t.z.i0), c100 = g(t.x.i1, t.y.i0, t.z.i0);
    const float c010 = g(t.x.i0, t.y.i1, t.z.i0), c110 = g(t.x.i1, t.y.i1, t.z.i0);
    const float c001 = g(t.x.i0, t.y.i0, t.z.i1), c101 = g(t.x.i1, t.y.i0, t.z.i1);
    const float c011 = g(t.x.i0, t.y.i1, t.z.i1), c111 = g(t.x.i1, t.y.i1, t.z.i1);
    const float c00 = c000 + (c100 - c000) * fx;
    const float c10 = c010 + (c110 - c010) * fx;
    const float c01 = c001 + (c101 - c001) * fx;
    const float c11 = c011 + (c111 - c011) * fx;
    const float c0 = c00 + (c10 - c00) * fy;
    const float c1 = c01 + (c11 - c01) * fy;
    return c0 + (c1 - c0) * fz;
  }
  const float a00 = t.x.w0 * g(t.x.i0, t.y.i0, t.z.i0) + t.x.w1 * g(t.x.i1, t.y.i0, t.z.i0);
  const float a10 = t.x.w0 * g(t.x.i0, t.y.i1, t.z.i0) + t.x.w1 * g(t.x.i1, t.y.i1, t.z.i0);
  const float a01 = t.x.w0 * g(t.x.i0, t.y.i0, t.z.i1) + t.x.w1 * g(t.x.i1, t.y.i0, t.z.i1);
  const float a11 = t.x.w0 * g(t.x.i0, t.y.i1, t.z.i1) + t.x.w1 * g(t.x.i1, t.y.i1, t.z.i1);
  const float b0 = t.y.w0 * a00 + t.y.w1 * a10;
  const float b1 = t.y.w0 * a01 + t.y.w1 * a11;
  return t.z.w0 * b0 + t.z.w1 * b1;
}

// Floor-corner rule on one axis: floor(clip(c)), and with a window the
// floored displacement clamped to [-K, K]. The result is always in range.
__device__ __forceinline__ int floor_coord(float c, int v, int n, int K) {
  float f = floorf(clampf(c, 0.0f, (float)(n - 1)));
  if (K >= 0) f = (float)v + clampf(f - (float)v, (float)(-K), (float)K);
  return (int)f;
}

// NaN-propagating max, so a NaN update stops the solve as it does in JAX.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Block-wide max of a non-negative value, folded into *out with atomicMax
// on its bits (the order of non-negative floats is that of their bits).
// Every thread of the block must call it; it may be called again at once.
__device__ __forceinline__ void block_max_atomic(float v, unsigned int* out) {
  __shared__ float warp_max[kBlock / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_max[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < kBlock / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) atomicMax(out, __float_as_uint(v));
  }
  __syncthreads();  // warp_max is free for the next call
}

// Block-wide sum in a fixed order: a shuffle tree inside each warp, then the
// same tree over the warp sums. The result is valid in thread 0. Every
// thread of the block must call it; it may be called again at once.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sum[kBlock / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sum[wid] = v;
  __syncthreads();
  float s = 0.0f;
  if (wid == 0) {
    s = lane < kBlock / 32 ? warp_sum[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  __syncthreads();  // warp_sum is free for the next call
  return s;
}

// Sum of n per-tile partials by ONE block in a fixed order: thread t adds
// partials t, t + kBlock, t + 2 kBlock, ... in turn, then block_sum. No
// float atomics, so the result is the same on every run. Valid in thread 0.
__device__ __forceinline__ float sum_partials(const float* partials, long long n) {
  float s = 0.0f;
  for (long long k = threadIdx.x; k < n; k += kBlock) s += partials[k];
  return block_sum(s);
}

}  // namespace sobfu
