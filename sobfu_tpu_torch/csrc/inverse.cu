// Kernel C: n steps of the inverse-field fixed point q <- v - disp(psi)(q).
//
// Replaces sobfu_tpu/ops/pallas_kernels.py estimate_inverse_window_pallas_multi
// (:3061, body _make_inverse_multi_kernel :2974) and the step-chained
// estimate_inverse_window_pallas (:1883); in exact mode (K < 0) it is the
// reference's 48-step estimate_inverse (vector_fields.cu:111-138).
//
// Each voxel iterates on its own: q(v) depends only on q(v) and on the
// constant field psi, so all n steps run inside one launch with no grid
// synchronisation. disp = psi - identity is formed at each corner on the fly
// (the same f32 subtraction the plain version makes up front), so no
// displacement volume is written.
//
// Bound on the H100: memory latency of the dependent gathers — step s+1
// cannot issue its 24 corner loads before step s has finished. The
// corners lie within K voxels (window) or near the solved field (exact),
// so they mostly hit L1/L2; occupancy (one thread per voxel, 8192 blocks at
// 128^3) hides the latency. One pass writes q once instead of n times.
#include "sampling.cuh"

namespace sobfu {

__global__ void inverse_kernel(const float* __restrict__ psi,
                               const float* __restrict__ init, float* __restrict__ out,
                               int Z, int Y, int X, int K, float hi, int n_steps) {
  const long long N = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int x = (int)(i % X);
  const int y = (int)((i / X) % Y);
  const int z = (int)(i / ((long long)X * Y));
  float qx, qy, qz;
  if (init != nullptr) {
    qx = init[i];
    qy = init[N + i];
    qz = init[2 * N + i];
  } else {
    qx = (float)x;
    qy = (float)y;
    qz = (float)z;
  }
  const float* px = psi;
  const float* py = psi + N;
  const float* pz = psi + 2 * N;
  for (int s = 0; s < n_steps; ++s) {
    const Taps3 t = taps3(qx, qy, qz, x, y, z, Z, Y, X, K, hi);
    const bool exact = K < 0;
    const float ax = trilinear(t, exact, [&](int xi, int yi, int zi) {
      return __ldg(px + flat_index(xi, yi, zi, Y, X)) - (float)xi;
    });
    const float ay = trilinear(t, exact, [&](int xi, int yi, int zi) {
      return __ldg(py + flat_index(xi, yi, zi, Y, X)) - (float)yi;
    });
    const float az = trilinear(t, exact, [&](int xi, int yi, int zi) {
      return __ldg(pz + flat_index(xi, yi, zi, Y, X)) - (float)zi;
    });
    qx = (float)x - ax;
    qy = (float)y - ay;
    qz = (float)z - az;
  }
  out[i] = qx;
  out[N + i] = qy;
  out[2 * N + i] = qz;
}

}  // namespace sobfu

// psi, out f32[3,Z,Y,X]; init f32[3,Z,Y,X] or null (identity); K < 0 = exact.
extern "C" int sobfu_inverse_fixed_point(const float* psi, const float* init, float* out,
                                         int Z, int Y, int X, int K, int n_steps,
                                         void* stream) {
  const long long N = (long long)Z * Y * X;
  const float hi = (float)((double)K - 1e-4);
  sobfu::inverse_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0, (cudaStream_t)stream>>>(
      psi, init, out, Z, Y, X, K, hi, n_steps);
  return (int)cudaGetLastError();
}
