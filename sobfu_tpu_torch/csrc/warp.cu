// Kernel B: warp C channels of a volume at the deformation psi.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py window_warp_pallas (:478, body
// _make_warp_kernel :232) and window_warp_pallas_mixed (:508). The TPU has
// no gather, so it sums (2K+1)^3 statically shifted tiles with hat weights;
// Hopper gathers, so this kernel reads the 8 live corners (1 for the floor
// rule) directly: the zero-weight taps of the shift-sum contribute exact
// zeros, and the live ones are added in the same order.
//
// Bound on the H100: memory. Per voxel it reads psi (12 B) and 8 corners
// per channel, which sit within K voxels of the voxel itself and mostly hit
// L1/L2, and writes 4 B per channel. Design: one thread per voxel, x
// fastest, so psi, the output and the corner rows are read coalesced; the
// corner taps are computed once and shared by all channels.
#include "sampling.cuh"

namespace sobfu {

__global__ void warp_kernel(const float* __restrict__ vol, int C,
                            const float* __restrict__ psi, float* __restrict__ out,
                            int Z, int Y, int X, int K, float hi, unsigned floor_mask) {
  const long long N = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int x = (int)(i % X);
  const int y = (int)((i / X) % Y);
  const int z = (int)(i / ((long long)X * Y));
  const float px = psi[i], py = psi[N + i], pz = psi[2 * N + i];
  const Taps3 t = taps3(px, py, pz, x, y, z, Z, Y, X, K, hi);
  const long long fidx = flat_index(floor_coord(px, x, X, K), floor_coord(py, y, Y, K),
                                    floor_coord(pz, z, Z, K), Y, X);
  for (int c = 0; c < C; ++c) {
    const float* v = vol + c * N;
    float r;
    if ((floor_mask >> c) & 1u) {
      r = __ldg(v + fidx);
    } else {
      r = trilinear(t, K < 0, [&](int xi, int yi, int zi) {
        return __ldg(v + flat_index(xi, yi, zi, Y, X));
      });
    }
    out[c * N + i] = r;
  }
}

}  // namespace sobfu

// vol f32[C,Z,Y,X], psi f32[3,Z,Y,X], out f32[C,Z,Y,X]; K < 0 = exact
// (no clamp); bit c of floor_mask selects the floor-corner rule for channel c.
extern "C" int sobfu_warp(const float* vol, int C, const float* psi, float* out, int Z,
                          int Y, int X, int K, unsigned floor_mask, void* stream) {
  const long long N = (long long)Z * Y * X;
  const float hi = (float)((double)K - 1e-4);
  sobfu::warp_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0, (cudaStream_t)stream>>>(
      vol, C, psi, out, Z, Y, X, K, hi, floor_mask);
  return (int)cudaGetLastError();
}
