// Kernel B: warp C channels of a volume at the deformation psi.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py window_warp_pallas (:478, body
// _make_warp_kernel :232), window_warp_pallas_mixed (:508) and, with three
// trilinear channels, window_warp_field3_pallas (:3309). The TPU has no
// gather, so it sums (2K+1)^3 statically shifted tiles with hat weights;
// Hopper gathers, so this kernel reads the 8 live corners (1 for the floor
// rule) directly: the zero-weight taps of the shift-sum contribute exact
// zeros, and the live ones are added in the same order.
//
// Bound on the H100: memory. Per voxel it must read psi (12 B) and the
// volume once (4 B a channel) and write 4 B a channel; the 8 corners of a
// channel sit near the voxel and are served by L1/L2, so what the kernel
// pays beyond the bound is its load instructions, the sectors each touches
// and their address arithmetic. Design (warpn_kernel):
//   - 32-bit voxel arithmetic: one division chain of the voxel index (x,
//     then y, then z); corner offsets are ints inside a channel, 64 bits
//     only for the channel base. The entry point refuses volumes of 2^31
//     voxels or more;
//   - compile-time variants: exact or window sampler, C in {1, 2, 3} and the
//     floor mask are template parameters, so the taps are computed only when
//     a channel is trilinear, the floor index only when a channel asks for
//     it, and the per-channel rule is resolved at compile time;
//   - a thread takes kPer voxels one block width apart, so each of a warp's
//     loads stays on 32 consecutive voxels (4 sectors of psi and output, the
//     corner rows beside them) while kPer voxels' gathers are in flight per
//     thread: kPer = 2 with one channel, 1 with two or three;
//   - the generic kernel (run-time C and mask, one voxel a thread) serves
//     C > 3.
// What was tried, device time per launch at 128^3 on an H100 80GB HBM3 at
// 700 W (torch.profiler): the kernel before (one voxel a thread, 64-bit
// index arithmetic, run-time K, C and mask) 0.0424 ms for the exact warp at
// +-3.5 voxels of random displacement, 0.0331 at +-1.8, 0.0362 for K=2,
// 0.0590 for three channels at K=2. Four consecutive x voxels a thread with
// psi and the output as float4: 0.0568 / 0.0312 / 0.0273 / 0.1368 — slower
// where the gathers scatter, because a warp's load then spans 128 voxels (16
// sectors and more) instead of 32. kPer voxels a block width apart, kPer =
// 1 / 2 / 4: exact +-3.5 0.0430 / 0.0372 / 0.0443; exact +-1.8 0.0224 /
// 0.0212 / 0.0231; K=2 0.0218 / 0.0226 / 0.0230; three channels 0.0617 /
// 0.0750 / 0.0617. The corners are read with __ldg (the volume is read-only
// for the launch); paired loads of the two x corners were not tried: the
// pair is aligned for even i0 only. The arithmetic order is sampling.cuh's
// (--fmad=false), so the floor channel stays bit for bit equal to the plain
// version.
#include "sampling.cuh"

namespace sobfu {

// One voxel: emit(c, the sample of channel c) for its C channels.
template <bool kExact, typename Rule, typename Emit>
__device__ __forceinline__ void warp_voxel(const float* __restrict__ vol, int C, Rule is_floor,
                                           bool any_floor, bool any_tri, unsigned N, float px,
                                           float py, float pz, int x, int y, int z, int Z,
                                           int Y, int X, int K, float hi, Emit emit) {
  Taps3 t;
  if (any_tri) t = taps3_t<kExact>(px, py, pz, x, y, z, Z, Y, X, K, hi);
  int fidx = 0;
  if (any_floor) {
    const int Kf = kExact ? -1 : K;
    fidx = (floor_coord(pz, z, Z, Kf) * Y + floor_coord(py, y, Y, Kf)) * X +
           floor_coord(px, x, X, Kf);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* v = vol + (size_t)c * N;
    if (is_floor(c)) {
      emit(c, __ldg(v + fidx));
    } else {
      emit(c, trilinear(t, kExact, [&](int xi, int yi, int zi) {
             return __ldg(v + ((zi * Y + yi) * X + xi));
           }));
    }
  }
}

// kPer voxels a thread, kBlock apart (every load of a warp stays on 32
// consecutive voxels); any X, any alignment.
template <bool kExact, int kC, unsigned kMask, int kPer>
__global__ void __launch_bounds__(kBlock)
    warpn_kernel(const float* __restrict__ vol, const float* __restrict__ psi,
                 float* __restrict__ out, int Z, int Y, int X, int K, float hi) {
  const unsigned N = (unsigned)Z * Y * X;
  const unsigned base = blockIdx.x * (kBlock * kPer) + threadIdx.x;
  constexpr unsigned all = (1u << kC) - 1u;
  float r[kC * kPer];
  float px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned i = base + j * kBlock;
    if (i < N) {
      px[j] = __ldg(psi + i);
      py[j] = __ldg(psi + (size_t)N + i);
      pz[j] = __ldg(psi + 2 * (size_t)N + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned i = base + j * kBlock;
    if (i >= N) continue;
    const unsigned row = i / X;
    const int x = (int)(i - row * X);
    const int z = (int)(row / Y);
    const int y = (int)(row - (unsigned)z * Y);
    warp_voxel<kExact>(
        vol, kC, [](int c) { return ((kMask >> c) & 1u) != 0u; }, (kMask & all) != 0u,
        (kMask & all) != all, N, px[j], py[j], pz[j], x, y, z, Z, Y, X, K, hi,
        [&](int c, float v) { r[c * kPer + j] = v; });
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned i = base + j * kBlock;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) out[(size_t)c * N + i] = r[c * kPer + j];
  }
}

// Any C <= 32, any X, any alignment: one voxel a thread.
template <bool kExact>
__global__ void __launch_bounds__(kBlock)
    warp1_kernel(const float* __restrict__ vol, int C, const float* __restrict__ psi,
                 float* __restrict__ out, int Z, int Y, int X, int K, float hi,
                 unsigned floor_mask) {
  const unsigned N = (unsigned)Z * Y * X;
  const unsigned i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= N) return;
  const unsigned row = i / X;
  const int x = (int)(i - row * X);
  const int z = (int)(row / Y);
  const int y = (int)(row - (unsigned)z * Y);
  const unsigned all = C >= 32 ? 0xffffffffu : (1u << C) - 1u;
  warp_voxel<kExact>(
      vol, C, [&](int c) { return ((floor_mask >> c) & 1u) != 0u; }, (floor_mask & all) != 0u,
      (floor_mask & all) != all, N, psi[i], psi[(size_t)N + i], psi[2 * (size_t)N + i], x, y,
      z, Z, Y, X, K, hi, [&](int c, float v) { out[(size_t)c * N + i] = v; });
}

template <int kC, unsigned kMask>
void launch_warpn(const float* vol, const float* psi, float* out, int Z, int Y, int X, int K,
                  float hi, cudaStream_t st) {
  constexpr int kPer = kC == 1 ? 2 : 1;
  const int blocks = blocks_for(((long long)Z * Y * X + kPer - 1) / kPer);
  if (K < 0)
    warpn_kernel<true, kC, kMask, kPer><<<blocks, kBlock, 0, st>>>(vol, psi, out, Z, Y, X, K, hi);
  else
    warpn_kernel<false, kC, kMask, kPer><<<blocks, kBlock, 0, st>>>(vol, psi, out, Z, Y, X, K,
                                                                    hi);
}

}  // namespace sobfu

// vol f32[C,Z,Y,X], psi f32[3,Z,Y,X], out f32[C,Z,Y,X]; K < 0 = exact
// (no clamp); bit c of floor_mask selects the floor-corner rule for channel
// c. 1 <= C <= 32; Z*Y*X < 2^31.
extern "C" int sobfu_warp(const float* vol, int C, const float* psi, float* out, int Z,
                          int Y, int X, int K, unsigned floor_mask, void* stream) {
  using namespace sobfu;
  const long long N = (long long)Z * Y * X;
  if (C < 1 || C > 32 || N < 1 || N >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const float hi = (float)((double)K - 1e-4);
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 3) {
    switch (C * 8 + (int)(floor_mask & ((1u << C) - 1u))) {
#define SOBFU_WARP_CASE(C_, M_)                              \
  case C_ * 8 + M_:                                          \
    launch_warpn<C_, M_>(vol, psi, out, Z, Y, X, K, hi, st); \
    break;
      SOBFU_WARP_CASE(1, 0) SOBFU_WARP_CASE(1, 1)
      SOBFU_WARP_CASE(2, 0) SOBFU_WARP_CASE(2, 1) SOBFU_WARP_CASE(2, 2) SOBFU_WARP_CASE(2, 3)
      SOBFU_WARP_CASE(3, 0) SOBFU_WARP_CASE(3, 1) SOBFU_WARP_CASE(3, 2) SOBFU_WARP_CASE(3, 3)
      SOBFU_WARP_CASE(3, 4) SOBFU_WARP_CASE(3, 5) SOBFU_WARP_CASE(3, 6) SOBFU_WARP_CASE(3, 7)
#undef SOBFU_WARP_CASE
    }
  } else if (K < 0) {
    warp1_kernel<true><<<blocks_for(N), kBlock, 0, st>>>(vol, C, psi, out, Z, Y, X, K, hi,
                                                        floor_mask);
  } else {
    warp1_kernel<false><<<blocks_for(N), kBlock, 0, st>>>(vol, C, psi, out, Z, Y, X, K, hi,
                                                         floor_mask);
  }
  return (int)cudaGetLastError();
}
