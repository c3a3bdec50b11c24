// Kernel B: warp C channels of a volume at the deformation psi.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py window_warp_pallas (:478, body
// _make_warp_kernel :232), window_warp_pallas_mixed (:508) and, with three
// trilinear channels (warp_field3), window_warp_field3_pallas (:3309); the
// exact form of three channels replaces XLA's gather in sobfu_tpu/fields.py
// sample_field_trilinear (:473), which has no Pallas kernel. The TPU has no
// gather, so it sums (2K+1)^3 statically shifted tiles with hat weights;
// Hopper gathers, so this kernel reads the 8 live corners (1 for the floor
// rule) directly: the zero-weight taps of the shift-sum contribute exact
// zeros, and the live ones are added in the same order.
//
// Bound on the H100: memory. Per voxel it must read psi (12 B) and the
// volume once (4 B a channel) and write 4 B a channel: for three channels at
// 128^3 75.5 MB, 0.0225 ms at 3.35 TB/s. The corners are gathered through
// L1, and what the kernel pays beyond the bound is the L1's: a warp's load
// of a corner touches one line per distinct (y, z) row among its 32 voxels
// (about 20 at +-3.5 voxels of independent noise, reckoned from the
// positions' spread), and the lines stay
// resident only if the block's voxels reuse them. Design (warpn_kernel):
//   - 3-D tiles: a block of 256 threads takes 32 x 4 x 2 voxels (one x row
//     of 32 a warp, so psi's loads and the stores stay coalesced). Its
//     corners at +-3.5 voxels span 40 x 12 x 10 rows, 58 KB for three
//     channels, against 147 KB for two rows of 128 voxels, so the 8 blocks
//     an SM runs keep their lines in L1 between warps;
//   - the taps and the 8 corner offsets once a voxel (corner_offsets), the
//     corners of every channel loaded together, blended in sampling.cuh's
//     order (blend8, --fmad=false): every channel bit for bit equal to the
//     plain version, and three channels to three one-channel launches;
//   - one channel two voxels a thread (the tile stacked two deep in z); two
//     channels (the tails' mixed warp) one voxel a thread in rows of 256,
//     where tiles were 4-7% slower at the smooth K=2 field; three one;
//   - compile-time variants: exact or window sampler, C in {1, 2, 3}, the
//     floor mask, the tile; 32-bit voxel arithmetic, the entry point
//     refuses volumes of 2^31 voxels or more; the generic kernel (run-time C
//     and mask, one voxel a thread in rows) serves C > 3.
// What was measured (tools/probe_warp_field3.py, device ms per call at
// 128^3 on an H100 80GB HBM3 at 700 W, each variant in turns with the
// others; exact at +-3.5 voxels of noise / exact at a smooth field of 3.5
// voxels / K=2 at +-1.8 of noise / K=2 at a smooth field of 1.95):
//   three channels, the kernel before (rows of 256, one voxel a thread)
//     0.1491 / 0.0409 / 0.0614 / 0.0355; grid_sample 0.0985 / 0.0686 /
//     0.0714 / 0.0663; three one-channel launches 0.0793 / 0.0575 / 0.0665
//     / 0.0586 (with this kernel's one-channel form). Its SASS holds 27 LDG
//     (24 corners and psi) and the offsets once, so recomputed corner
//     indices were not the cause; two voxels a thread 0.1570 / 0.0417 /
//     0.0754 / 0.0368, so neither were too few gathers in flight;
//   - the offsets once, in rows: 0.1396 / 0.0413 / 0.0616 / 0.0354; channel
//     by channel (8 loads, blend, store) 0.1377 / 0.0412 / 0.0628 / 0.0357;
//   - a first kernel interleaving the field into float4 [Z,Y,X,4] (8 loads
//     of 16 B a voxel): 0.1080 / 0.0594 / 0.0863 / 0.0584, on 32 x 4 x 2
//     tiles 0.0834 / 0.0572 / 0.0680 / 0.0578: fewer loads, but as many
//     lines a load, and the interleaving pass costs 0.02;
//   - the corners' bounding box staged in shared memory a block of 32 x 8 x
//     4 (32 x 8 x 8): 0.1543 / 0.1138 / 0.0771 / 0.0661 (0.2290 / 0.1793 /
//     0.0821 / 0.0727), the box 5-7.5 times the block's voxels;
//   - tiles: 32 x 4 x 2 0.0750 / 0.0373 / 0.0438 / 0.0326 (this kernel
//     0.0742 / 0.0369 / 0.0445 / 0.0327); 32 x 2 x 4 0.0757 / 0.0369 /
//     0.0436 / 0.0322; 32 x 8 x 1 0.0859 / 0.0385 / 0.0452 / 0.0336; 16 x 4
//     x 4 0.0723 / 0.0374 / 0.0493 / 0.0360; 16 x 8 x 2 0.0793 / 0.0377 /
//     0.0497 / 0.0371; 8 x 8 x 4 0.0888 / 0.0462 / 0.0627 / 0.0449; stacked
//     in z two deep 0.0758 / 0.0382 / 0.0446 / 0.0347, four deep 0.0650 /
//     0.0381 / 0.0442 / 0.0346 (faster at the noise, slower at the smooth
//     fields that real compositions resemble); the shared-memory carveout
//     at 0 (the most L1) 0.0749 / 0.0373 / 0.0438 / 0.0325;
//   - one channel, rows two voxels a thread (before) 0.0377 / 0.0193 /
//     0.0226 / 0.0206, tiles 0.0256 / 0.0180 / 0.0215 / 0.0190; the mixed
//     two channels, rows (before) 0.0568 / 0.0247 / 0.0307 / 0.0233, tiles
//     0.0380 / 0.0243 / 0.0261 / 0.0246.
// Three channels now reach 30% of the bound exact at the noise (51% at
// K=2, 61% exact and 69% at K=2 on the smooth fields); what holds them
// back at the noise is still the L1's lines a load: ~20 a warp's load, 24
// loads a voxel. The corners are read with __ldg (the volume is read-only
// for the launch); paired loads of the two x corners were not tried: the
// pair is aligned for even i0 only.
#include "sampling.cuh"

namespace sobfu {

// The voxels of a block of warpn_kernel, kPer a thread: with kTX = 0 the
// rows of the volume (voxel b kBlock kPer + t + j kBlock, any X); else a
// tile of kTX x kTY x kTZ voxels (x fastest, kTX kTY kTZ = kBlock) stacked
// kPer deep in z, j stepping kTZ planes.
struct Voxel {
  int x, y, z;
  unsigned i;
  bool ok;
};

template <int kTX, int kTY, int kPer>
__device__ __forceinline__ Voxel voxel_of(int j, int Z, int Y, int X, int tiles_x,
                                          int tiles_y) {
  Voxel v;
  if constexpr (kTX == 0) {
    v.i = blockIdx.x * (kBlock * kPer) + threadIdx.x + j * kBlock;
    v.ok = v.i < (unsigned)Z * Y * X;
    const unsigned row = v.i / X;
    v.x = (int)(v.i - row * X);
    v.z = (int)(row / Y);
    v.y = (int)(row - (unsigned)v.z * Y);
  } else {
    constexpr int kTZ = kBlock / (kTX * kTY);
    const int b = blockIdx.x, bx = b % tiles_x, r = b / tiles_x;
    const int by = r % tiles_y, bz = r / tiles_y;
    v.x = bx * kTX + (int)(threadIdx.x % kTX);
    v.y = by * kTY + (int)(threadIdx.x / kTX) % kTY;
    v.z = (bz * kPer + j) * kTZ + (int)(threadIdx.x / (kTX * kTY));
    v.ok = v.x < X && v.y < Y && v.z < Z;
    v.i = ((unsigned)v.z * Y + v.y) * X + v.x;
  }
  return v;
}

// One voxel: emit(c, the sample of channel c) for its C channels. The taps
// and the 8 corner offsets are computed once for every trilinear channel.
template <bool kExact, typename Rule, typename Emit>
__device__ __forceinline__ void warp_voxel(const float* __restrict__ vol, int C, Rule is_floor,
                                           bool any_floor, bool any_tri, unsigned N, float px,
                                           float py, float pz, int x, int y, int z, int Z,
                                           int Y, int X, int K, float hi, Emit emit) {
  Taps3 t;
  int o[8];
  if (any_tri) {
    t = taps3_t<kExact>(px, py, pz, x, y, z, Z, Y, X, K, hi);
    corner_offsets(t, Y, X, o);
  }
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
      float corner[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) corner[k] = __ldg(v + o[k]);
      emit(c, blend8(t, kExact, corner));
    }
  }
}

// kPer voxels a thread in rows or tiles (voxel_of); any X, any alignment.
template <bool kExact, int kC, unsigned kMask, int kPer, int kTX, int kTY>
__global__ void __launch_bounds__(kBlock)
    warpn_kernel(const float* __restrict__ vol, const float* __restrict__ psi,
                 float* __restrict__ out, int Z, int Y, int X, int K, float hi, int tiles_x,
                 int tiles_y) {
  const unsigned N = (unsigned)Z * Y * X;
  constexpr unsigned all = (1u << kC) - 1u;
  Voxel v[kPer];
  float px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = voxel_of<kTX, kTY, kPer>(j, Z, Y, X, tiles_x, tiles_y);
    if (v[j].ok) {
      px[j] = __ldg(psi + v[j].i);
      py[j] = __ldg(psi + (size_t)N + v[j].i);
      pz[j] = __ldg(psi + 2 * (size_t)N + v[j].i);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!v[j].ok) continue;
    const unsigned i = v[j].i;
    warp_voxel<kExact>(
        vol, kC, [](int c) { return ((kMask >> c) & 1u) != 0u; }, (kMask & all) != 0u,
        (kMask & all) != all, N, px[j], py[j], pz[j], v[j].x, v[j].y, v[j].z, Z, Y, X, K, hi,
        [&](int c, float s) { out[(size_t)c * N + i] = s; });
  }
}

// Any C <= 32, any X, any alignment: one voxel a thread.
template <bool kExact>
__global__ void __launch_bounds__(kBlock)
    warp1_kernel(const float* __restrict__ vol, int C, const float* __restrict__ psi,
                 float* __restrict__ out, int Z, int Y, int X, int K, float hi,
                 unsigned floor_mask) {
  const unsigned N = (unsigned)Z * Y * X;
  const Voxel v = voxel_of<0, 0, 1>(0, Z, Y, X, 1, 1);
  if (!v.ok) return;
  const unsigned i = v.i, all = C >= 32 ? 0xffffffffu : (1u << C) - 1u;
  warp_voxel<kExact>(
      vol, C, [&](int c) { return ((floor_mask >> c) & 1u) != 0u; }, (floor_mask & all) != 0u,
      (floor_mask & all) != all, N, psi[i], psi[(size_t)N + i], psi[2 * (size_t)N + i], v.x,
      v.y, v.z, Z, Y, X, K, hi, [&](int c, float s) { out[(size_t)c * N + i] = s; });
}

template <int kC, unsigned kMask, int kPer, int kTX, int kTY>
void launch_warpn(const float* vol, const float* psi, float* out, int Z, int Y, int X, int K,
                  float hi, cudaStream_t st) {
  constexpr int kX = kTX == 0 ? 1 : kTX, kY = kTX == 0 ? 1 : kTY, kTZ = kBlock / (kX * kY);
  const int tiles_x = (X + kX - 1) / kX, tiles_y = (Y + kY - 1) / kY;
  const int blocks = kTX == 0 ? blocks_for(((long long)Z * Y * X + kPer - 1) / kPer)
                              : tiles_x * tiles_y * ((Z + kTZ * kPer - 1) / (kTZ * kPer));
  if (K < 0)
    warpn_kernel<true, kC, kMask, kPer, kTX, kTY>
        <<<blocks, kBlock, 0, st>>>(vol, psi, out, Z, Y, X, K, hi, tiles_x, tiles_y);
  else
    warpn_kernel<false, kC, kMask, kPer, kTX, kTY>
        <<<blocks, kBlock, 0, st>>>(vol, psi, out, Z, Y, X, K, hi, tiles_x, tiles_y);
}

// B's launch shape a channel count: one channel two voxels a thread in
// tiles of 32 x 4 x 2, two channels one a thread in rows, three one a
// thread in tiles of 32 x 4 x 2
template <int kC, unsigned kMask>
void launch_warpn(const float* vol, const float* psi, float* out, int Z, int Y, int X, int K,
                  float hi, cudaStream_t st) {
  if constexpr (kC == 1)
    launch_warpn<kC, kMask, 2, 32, 4>(vol, psi, out, Z, Y, X, K, hi, st);
  else if constexpr (kC == 2)
    launch_warpn<kC, kMask, 1, 0, 0>(vol, psi, out, Z, Y, X, K, hi, st);
  else
    launch_warpn<kC, kMask, 1, 32, 4>(vol, psi, out, Z, Y, X, K, hi, st);
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
