// Kernel D: floor-warp the live weight at psi and fuse the warped live frame
// into the canonical volume.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py window_warp_fuse_pallas (:607,
// body _make_warp_fuse_kernel :532). Per voxel:
//   wnp  = weight_n[floor corner of psi]   (K-clamped, or exact with K < 0)
//   skip = wnp == 0 or (wnp == 1 and tnp in {0, -1})
//   tsdf = skip ? tg : (wg * tg + tnp) / (wg + 1)
//   w    = skip ? wg : min(wg + 1, max_weight)
// (reference tsdf_volume.cu:103-130; tsdf.fuse_volumes). The numerator is one
// fused multiply-add (__fmaf_rn) — the rounding XLA gives fuse_volumes and
// torch.addcmul gives the plain version — and the rest uses round-to-nearest
// intrinsics, so the result is bit-identical to both.
//
// Bound on the H100: memory — 5 volumes and psi read (32 B/voxel), 2
// written (8 B/voxel), one gather per voxel. Design: one thread per voxel,
// fully coalesced except the single weight gather, which lies within K
// voxels; the separate weight-warp pass and its round trip through device
// memory are gone.
#include "sampling.cuh"

namespace sobfu {

__global__ void warp_fuse_kernel(const float* __restrict__ tg, const float* __restrict__ wg,
                                 const float* __restrict__ tnp,
                                 const float* __restrict__ wn,
                                 const float* __restrict__ psi, float max_weight,
                                 float* __restrict__ tg_out, float* __restrict__ wg_out,
                                 int Z, int Y, int X, int K) {
  const long long N = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int x = (int)(i % X);
  const int y = (int)((i / X) % Y);
  const int z = (int)(i / ((long long)X * Y));
  const long long fidx =
      flat_index(floor_coord(psi[i], x, X, K), floor_coord(psi[N + i], y, Y, K),
                 floor_coord(psi[2 * N + i], z, Z, K), Y, X);
  const float wnp = __ldg(wn + fidx);
  const float t = tnp[i];
  const float g = tg[i];
  const float w = wg[i];
  const bool skip = (wnp == 0.0f) || ((wnp == 1.0f) && ((t == 0.0f) || (t == -1.0f)));
  if (skip) {
    tg_out[i] = g;
    wg_out[i] = w;
  } else {
    const float w1 = __fadd_rn(w, 1.0f);
    tg_out[i] = __fdiv_rn(__fmaf_rn(w, g, t), w1);
    wg_out[i] = fminf(w1, max_weight);
  }
}

}  // namespace sobfu

// tg, wg, tnp, wn, tg_out, wg_out f32[Z,Y,X]; psi f32[3,Z,Y,X]; K < 0 = exact.
extern "C" int sobfu_warp_fuse(const float* tg, const float* wg, const float* tnp,
                               const float* wn, const float* psi, float max_weight,
                               float* tg_out, float* wg_out, int Z, int Y, int X, int K,
                               void* stream) {
  const long long N = (long long)Z * Y * X;
  sobfu::warp_fuse_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0, (cudaStream_t)stream>>>(
      tg, wg, tnp, wn, psi, max_weight, tg_out, wg_out, Z, Y, X, K);
  return (int)cudaGetLastError();
}
