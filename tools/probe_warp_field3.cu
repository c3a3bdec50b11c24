// Variants of warp_field3 (kernel B on three trilinear channels) for
// tools/probe_warp_field3.py: the design measured against the alternatives
// that csrc/warp.cu's header note reports. Built with the package's nvcc
// flags and -I sobfu_tpu_torch/csrc; every variant computes the same bits as
// warp_field3_plain (same taps, same blend order, --fmad=false).
//
//   0 parent      csrc/warp.cu before its redesign: warpn_kernel<kExact, 3,
//                 0, 1>, one voxel a thread, rows of 256 voxels, the 24
//                 corner loads of a voxel issued together
//   1 parent_per2 the same with two voxels a thread, a block width apart
//   2 once        the corner offsets computed once a voxel (corner_offsets),
//                 the 24 loads issued together
//   3 once_seq    the same, channel by channel: 8 loads, blend, store
//   4 tile        `once` on 3-D blocks of 32 x 4 x 2 voxels
//   5 f4          a first kernel interleaves the field into float4 [Z,Y,X,4];
//                 the gather reads a corner's three channels in one 16-byte
//                 load (8 loads a voxel), rows of 256 voxels
//   6 f4_tile     `f4` on 3-D blocks of 32 x 4 x 2 voxels
//   7 f4_per2     `f4` with two voxels a thread, a block width apart
//   8 staged      a block of 32 x 8 x 4 voxels reduces its corners' bounding
//                 box, copies the box of the three channels into shared
//                 memory (coalesced rows) and gathers from there; a box over
//                 the shared memory given gathers from global memory
//   9 staged_l    `staged` on blocks of 32 x 8 x 8 voxels
//  10-16 tile_AxBxC `tile` on 3-D blocks of A x B x C voxels
//  17, 18        `tile` (32 x 4 x 2) stacked 2 and 4 deep in z: a thread
//                takes 2 or 4 voxels, 2 planes apart
//  19            16 x 4 x 4 stacked 2 deep
//  20, 21        `tile` and 16 x 4 x 4 with the shared-memory carveout at 0
//                (the most L1)
//
// probe_warp runs B's forms (C channels, a floor mask; two voxels a thread
// for one channel, else one): 0 the parent's row kernel; 1 the package's
// launch (sobfu_warp); 2 the parent's voxel routine (the corners through
// trilinear's getter, results stored last) on tiles of 32 x 4 x 2; the
// package's warpn_kernel (corner_offsets, blend8) on 3 those tiles and 4
// rows.
#include <climits>

#include "warp.cu"

namespace probe {
using namespace sobfu;

// ---- 0, 1: the parent kernel, verbatim --------------------------------------

template <bool kExact, typename Rule, typename Emit>
__device__ __forceinline__ void p_warp_voxel(const float* __restrict__ vol, int C, Rule is_floor,
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

template <bool kExact, int kC, unsigned kMask, int kPer>
__global__ void __launch_bounds__(kBlock)
    p_warpn_kernel(const float* __restrict__ vol, const float* __restrict__ psi,
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
    p_warp_voxel<kExact>(
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

// the parent's kernel (its voxel routine, results stored last) on the
// package's voxel mapping (rows or tiles, sobfu::voxel_of)
template <bool kExact, int kC, unsigned kMask, int kPer, int kTX, int kTY>
__global__ void __launch_bounds__(kBlock)
    p_tile_kernel(const float* __restrict__ vol, const float* __restrict__ psi,
                  float* __restrict__ out, int Z, int Y, int X, int K, float hi, int tiles_x,
                  int tiles_y) {
  const unsigned N = (unsigned)Z * Y * X;
  constexpr unsigned all = (1u << kC) - 1u;
  float r[kC * kPer];
  float px[kPer], py[kPer], pz[kPer];
  Voxel v[kPer];
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
    p_warp_voxel<kExact>(
        vol, kC, [](int c) { return ((kMask >> c) & 1u) != 0u; }, (kMask & all) != 0u,
        (kMask & all) != all, N, px[j], py[j], pz[j], v[j].x, v[j].y, v[j].z, Z, Y, X, K, hi,
        [&](int c, float s) { r[c * kPer + j] = s; });
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!v[j].ok) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) out[(size_t)c * N + v[j].i] = r[c * kPer + j];
  }
}

// ---- 2-7: the gather with the offsets once a voxel --------------------------

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : v.z;
}

// kLayout 0: planar, the 24 loads together; 1: planar, channel by channel;
// 2: interleaved float4
template <bool kExact, int kLayout, int kTX, int kTY, int kPer>
__global__ void __launch_bounds__(kBlock)
    gather3(const float* __restrict__ field, const float4* __restrict__ f4,
            const float* __restrict__ pos, float* __restrict__ out, int Z, int Y, int X, int K,
            float hi, int tiles_x, int tiles_y) {
  const unsigned N = (unsigned)Z * Y * X;
  Voxel v[kPer];
  float px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = voxel_of<kTX, kTY, kPer>(j, Z, Y, X, tiles_x, tiles_y);
    if (v[j].ok) {
      px[j] = __ldg(pos + v[j].i);
      py[j] = __ldg(pos + (size_t)N + v[j].i);
      pz[j] = __ldg(pos + 2 * (size_t)N + v[j].i);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!v[j].ok) continue;
    const Taps3 t = taps3_t<kExact>(px[j], py[j], pz[j], v[j].x, v[j].y, v[j].z, Z, Y, X, K, hi);
    int o[8];
    corner_offsets(t, Y, X, o);
    const unsigned i = v[j].i;
    if (kLayout == 2) {
      float4 c4[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) c4[k] = __ldg(f4 + o[k]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float c[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = lane(c4[k], ch);
        out[(size_t)ch * N + i] = blend8(t, kExact, c);
      }
    } else if (kLayout == 0) {
      float c[3][8];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int k = 0; k < 8; ++k) c[ch][k] = __ldg(field + (size_t)ch * N + o[k]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out[(size_t)ch * N + i] = blend8(t, kExact, c[ch]);
    } else {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float c[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = __ldg(field + (size_t)ch * N + o[k]);
        out[(size_t)ch * N + i] = blend8(t, kExact, c);
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    interleave3(const float* __restrict__ field, float4* __restrict__ f4, unsigned N) {
  const unsigned i = blockIdx.x * kBlock + threadIdx.x;
  if (i < N)
    f4[i] = make_float4(__ldg(field + i), __ldg(field + (size_t)N + i),
                        __ldg(field + 2 * (size_t)N + i), 0.0f);
}

// ---- 8, 9: the corners' box staged in shared memory -------------------------

__device__ __forceinline__ int block_min(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kBlock / 32; ++w) v = min(v, red[w]);
  __syncthreads();
  return v;
}

// a block of 32 x 8 x kTZ voxels: thread (lane, warp) takes x = lane, y =
// warp and kTZ planes; cap is the shared memory's floats
template <bool kExact, int kTZ>
__global__ void __launch_bounds__(kBlock)
    staged3(const float* __restrict__ field, const float* __restrict__ pos,
            float* __restrict__ out, int Z, int Y, int X, int K, float hi, int tiles_x,
            int tiles_y, int cap) {
  extern __shared__ float sm[];
  __shared__ int red[kBlock / 32];
  const unsigned N = (unsigned)Z * Y * X;
  const int b = blockIdx.x, bx = b % tiles_x, r = b / tiles_x;
  const int by = r % tiles_y, bz = r / tiles_y;
  const int x = bx * 32 + (threadIdx.x & 31), y = by * 8 + (threadIdx.x >> 5);
  float px[kTZ], py[kTZ], pz[kTZ];
  int lo_x = INT_MAX, lo_y = INT_MAX, lo_z = INT_MAX, nhi_x = INT_MAX, nhi_y = INT_MAX,
      nhi_z = INT_MAX;
#pragma unroll
  for (int j = 0; j < kTZ; ++j) {
    const int z = bz * kTZ + j;
    if (x < X && y < Y && z < Z) {
      const unsigned i = ((unsigned)z * Y + y) * X + x;
      px[j] = __ldg(pos + i);
      py[j] = __ldg(pos + (size_t)N + i);
      pz[j] = __ldg(pos + 2 * (size_t)N + i);
      const Taps3 t = taps3_t<kExact>(px[j], py[j], pz[j], x, y, z, Z, Y, X, K, hi);
      lo_x = min(lo_x, t.x.i0); nhi_x = min(nhi_x, -t.x.i1);
      lo_y = min(lo_y, t.y.i0); nhi_y = min(nhi_y, -t.y.i1);
      lo_z = min(lo_z, t.z.i0); nhi_z = min(nhi_z, -t.z.i1);
    }
  }
  lo_x = block_min(lo_x, red); lo_y = block_min(lo_y, red); lo_z = block_min(lo_z, red);
  const int nx = 1 - block_min(nhi_x, red) - lo_x, ny = 1 - block_min(nhi_y, red) - lo_y;
  const int nz = 1 - block_min(nhi_z, red) - lo_z;
  const int box = nx * ny * nz;
  const bool staged = 3 * box <= cap;
  if (staged) {
    for (int row = threadIdx.x >> 5; row < ny * nz; row += kBlock / 32) {
      const int zz = row / ny, yy = row - zz * ny;
      const float* src = field + ((unsigned)(lo_z + zz) * Y + lo_y + yy) * X + lo_x;
      float* dst = sm + row * nx;
      for (int xx = threadIdx.x & 31; xx < nx; xx += 32) {
        dst[xx] = __ldg(src + xx);
        dst[box + xx] = __ldg(src + N + xx);
        dst[2 * box + xx] = __ldg(src + 2 * (size_t)N + xx);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kTZ; ++j) {
    const int z = bz * kTZ + j;
    if (!(x < X && y < Y && z < Z)) continue;
    const unsigned i = ((unsigned)z * Y + y) * X + x;
    Taps3 t = taps3_t<kExact>(px[j], py[j], pz[j], x, y, z, Z, Y, X, K, hi);
    int o[8];
    float c[3][8];
    if (staged) {
      Taps3 s = t;
      s.x.i0 -= lo_x; s.x.i1 -= lo_x; s.y.i0 -= lo_y; s.y.i1 -= lo_y;
      s.z.i0 -= lo_z; s.z.i1 -= lo_z;
      corner_offsets(s, ny, nx, o);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int k = 0; k < 8; ++k) c[ch][k] = sm[ch * box + o[k]];
    } else {
      corner_offsets(t, Y, X, o);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int k = 0; k < 8; ++k) c[ch][k] = __ldg(field + (size_t)ch * N + o[k]);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[(size_t)ch * N + i] = blend8(t, kExact, c[ch]);
  }
}

template <bool kExact, int kLayout, int kTX, int kTY, int kPer>
int launch_gather(const float* field, const float4* f4, const float* pos, float* out, int Z,
                  int Y, int X, int K, float hi, cudaStream_t st, bool max_l1 = false) {
  auto kernel = gather3<kExact, kLayout, kTX, kTY, kPer>;
  if (max_l1) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int kX = kTX == 0 ? 1 : kTX, kY = kTX == 0 ? 1 : kTY, kTZ = kBlock / (kX * kY);
  const int tx = (X + kX - 1) / kX, ty = (Y + kY - 1) / kY;
  const int blocks = kTX == 0 ? blocks_for(((long long)Z * Y * X + kPer - 1) / kPer)
                              : tx * ty * ((Z + kTZ * kPer - 1) / (kTZ * kPer));
  kernel<<<blocks, kBlock, 0, st>>>(field, f4, pos, out, Z, Y, X, K, hi, tx, ty);
  return 0;
}

template <bool kExact, int kTZ>
int launch_staged(const float* field, const float* pos, float* out, int Z, int Y, int X, int K,
                  float hi, int cap, cudaStream_t st) {
  const size_t bytes = (size_t)cap * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(staged3<kExact, kTZ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int tx = (X + 31) / 32, ty = (Y + 7) / 8, tz = (Z + kTZ - 1) / kTZ;
  staged3<kExact, kTZ><<<tx * ty * tz, kBlock, bytes, st>>>(field, pos, out, Z, Y, X, K, hi, tx,
                                                             ty, cap);
  return 0;
}

template <bool kExact>
int run(int variant, const float* field, const float* pos, float* out, float4* f4, int Z, int Y,
        int X, int K, float hi, cudaStream_t st) {
  const unsigned N = (unsigned)Z * Y * X;
  if (variant >= 5 && variant <= 7)
    interleave3<<<blocks_for(N), kBlock, 0, st>>>(field, f4, N);
  // shared memory of the staged blocks: the window's box where K bounds it,
  // else 96 KB (32 x 8 x 4) or 128 KB (32 x 8 x 8)
  const int pad = kExact ? 0 : 2 * K + 1;
  switch (variant) {
    case 0:
      p_warpn_kernel<kExact, 3, 0, 1><<<blocks_for(N), kBlock, 0, st>>>(field, pos, out, Z, Y,
                                                                        X, K, hi);
      break;
    case 1:
      p_warpn_kernel<kExact, 3, 0, 2><<<blocks_for((N + 1) / 2), kBlock, 0, st>>>(
          field, pos, out, Z, Y, X, K, hi);
      break;
    case 2: return launch_gather<kExact, 0, 0, 0, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 3: return launch_gather<kExact, 1, 0, 0, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 4: return launch_gather<kExact, 0, 32, 4, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 5: return launch_gather<kExact, 2, 0, 0, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 6: return launch_gather<kExact, 2, 32, 4, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 7: return launch_gather<kExact, 2, 0, 0, 2>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 8:
      return launch_staged<kExact, 4>(field, pos, out, Z, Y, X, K, hi,
                                      kExact ? 24576 : 3 * (32 + pad) * (8 + pad) * (4 + pad),
                                      st);
    case 9:
      return launch_staged<kExact, 8>(field, pos, out, Z, Y, X, K, hi,
                                      kExact ? 32768 : 3 * (32 + pad) * (8 + pad) * (8 + pad),
                                      st);
    case 10: return launch_gather<kExact, 0, 32, 8, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 11: return launch_gather<kExact, 0, 32, 2, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 12: return launch_gather<kExact, 0, 16, 4, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 13: return launch_gather<kExact, 0, 16, 8, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 14: return launch_gather<kExact, 0, 8, 8, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 15: return launch_gather<kExact, 0, 8, 4, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 16: return launch_gather<kExact, 0, 16, 2, 1>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 17: return launch_gather<kExact, 0, 32, 4, 2>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 18: return launch_gather<kExact, 0, 32, 4, 4>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 19: return launch_gather<kExact, 0, 16, 4, 2>(field, f4, pos, out, Z, Y, X, K, hi, st);
    case 20:
      return launch_gather<kExact, 0, 32, 4, 1>(field, f4, pos, out, Z, Y, X, K, hi, st, true);
    case 21:
      return launch_gather<kExact, 0, 16, 4, 1>(field, f4, pos, out, Z, Y, X, K, hi, st, true);
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace probe

// field, pos, out f32[3,Z,Y,X]; scratch f32[Z*Y*X*4] (variants 5-7); K < 0 =
// exact. Returns cudaGetLastError() (or the first error of a setup call).
extern "C" int probe_field3(int variant, const float* field, const float* pos, float* out,
                            float* scratch, int Z, int Y, int X, int K, void* stream) {
  const float hi = (float)((double)K - 1e-4);
  cudaStream_t st = (cudaStream_t)stream;
  float4* f4 = reinterpret_cast<float4*>(scratch);
  const int rc = K < 0 ? probe::run<true>(variant, field, pos, out, f4, Z, Y, X, K, hi, st)
                       : probe::run<false>(variant, field, pos, out, f4, Z, Y, X, K, hi, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

namespace probe {

template <int kC, unsigned kMask>
int run_b(int variant, const float* vol, const float* pos, float* out, int Z, int Y, int X,
          int K, float hi, cudaStream_t st) {
  constexpr int kP = kC == 1 ? 2 : 1;
  const unsigned N = (unsigned)Z * Y * X;
  const int tx = (X + 31) / 32, ty = (Y + 3) / 4, tz = (Z + 2 * kP - 1) / (2 * kP);
  switch (variant) {
    case 0:
      if (K < 0)
        p_warpn_kernel<true, kC, kMask, kP>
            <<<blocks_for((N + kP - 1) / kP), kBlock, 0, st>>>(vol, pos, out, Z, Y, X, K, hi);
      else
        p_warpn_kernel<false, kC, kMask, kP>
            <<<blocks_for((N + kP - 1) / kP), kBlock, 0, st>>>(vol, pos, out, Z, Y, X, K, hi);
      return 0;
    case 1: sobfu::launch_warpn<kC, kMask>(vol, pos, out, Z, Y, X, K, hi, st); return 0;
    case 2:
      if (K < 0)
        p_tile_kernel<true, kC, kMask, kP, 32, 4>
            <<<tx * ty * tz, kBlock, 0, st>>>(vol, pos, out, Z, Y, X, K, hi, tx, ty);
      else
        p_tile_kernel<false, kC, kMask, kP, 32, 4>
            <<<tx * ty * tz, kBlock, 0, st>>>(vol, pos, out, Z, Y, X, K, hi, tx, ty);
      return 0;
    case 3: sobfu::launch_warpn<kC, kMask, kP, 32, 4>(vol, pos, out, Z, Y, X, K, hi, st); return 0;
    case 4: sobfu::launch_warpn<kC, kMask, kP, 0, 0>(vol, pos, out, Z, Y, X, K, hi, st); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace probe

// vol, out f32[C,Z,Y,X]; (C, mask) one of (1, 0), (2, 2), (3, 0).
extern "C" int probe_warp(int variant, const float* vol, int C, const float* pos, float* out,
                          int Z, int Y, int X, int K, unsigned mask, void* stream) {
  const float hi = (float)((double)K - 1e-4);
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (C == 1 && mask == 0)
    rc = probe::run_b<1, 0>(variant, vol, pos, out, Z, Y, X, K, hi, st);
  else if (C == 2 && mask == 2)
    rc = probe::run_b<2, 2>(variant, vol, pos, out, Z, Y, X, K, hi, st);
  else if (C == 3 && mask == 0)
    rc = probe::run_b<3, 0>(variant, vol, pos, out, Z, Y, X, K, hi, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
