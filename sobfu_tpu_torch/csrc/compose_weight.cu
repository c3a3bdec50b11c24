// Kernel F: the compositive tail in one pass — psi_new = psi0 o g sampled in
// the window Kf, and weight_n floor-sampled at psi_new in the window Kw.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py compose_weight_pallas (:3223, body
// _make_compose_weight_kernel :3127). The TPU kernel sums (2Kf+1)^3 shifted
// halo tiles of psi0 per channel and then (2Kw+1)^3 one-hot shifts of the
// weight; Hopper gathers, so each thread reads the 8 live corners of each of
// psi0's three channels and the one floor voxel of the weight directly. The
// zero-weight taps of the shift-sum add exact zeros, and the live ones are
// added in the same order (sampling.cuh trilinear), so psi_new has the plain
// version's bits.
//
// The floor index is taken from psi_new as this thread has just computed and
// written it — the same f32 values the plain version's floor sample reads —
// so no psi_new voxel is ever re-rounded and no weight flips across an
// integer.
//
// Bound on the H100: memory. Per voxel it reads g (12 B), 24 corners of psi0
// within Kf voxels (mostly L1/L2 hits) and one weight, and writes 16 B. One
// thread per voxel, x fastest: g, the outputs and the corner rows coalesce,
// and the window taps are computed once for the three channels. Fusing the
// floor sample saves a psi_new round trip through device memory and a launch.
#include "sampling.cuh"

namespace sobfu {

__global__ void compose_weight_kernel(const float* __restrict__ field,
                                      const float* __restrict__ pos,
                                      const float* __restrict__ weight,
                                      float* __restrict__ out, float* __restrict__ wout,
                                      int Z, int Y, int X, int Kf, float hi, int Kw) {
  const long long N = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int x = (int)(i % X);
  const int y = (int)((i / X) % Y);
  const int z = (int)(i / ((long long)X * Y));
  const Taps3 t = taps3(pos[i], pos[N + i], pos[2 * N + i], x, y, z, Z, Y, X, Kf, hi);
  float p[3];
  for (int c = 0; c < 3; ++c) {
    const float* f = field + c * N;
    p[c] = trilinear(t, false, [&](int xi, int yi, int zi) {
      return __ldg(f + flat_index(xi, yi, zi, Y, X));
    });
    out[c * N + i] = p[c];
  }
  const long long widx = flat_index(floor_coord(p[0], x, X, Kw), floor_coord(p[1], y, Y, Kw),
                                    floor_coord(p[2], z, Z, Kw), Y, X);
  wout[i] = __ldg(weight + widx);
}

}  // namespace sobfu

// field (psi0), pos (g = id + delta, absolute) and out f32[3,Z,Y,X]; weight
// and wout f32[Z,Y,X]; Kf, Kw >= 0 are the window half-widths.
extern "C" int sobfu_compose_weight(const float* field, const float* pos, const float* weight,
                                    float* out, float* wout, int Z, int Y, int X, int Kf,
                                    int Kw, void* stream) {
  const long long N = (long long)Z * Y * X;
  const float hi = (float)((double)Kf - 1e-4);
  sobfu::compose_weight_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0,
                                 (cudaStream_t)stream>>>(field, pos, weight, out, wout, Z, Y,
                                                         X, Kf, hi, Kw);
  return (int)cudaGetLastError();
}
