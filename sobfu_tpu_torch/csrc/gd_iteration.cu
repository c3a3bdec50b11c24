// Kernel A: one Sobolev gradient-descent iteration of the warp-field solve.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py fused_gd_iteration_pp (:2443,
// body _make_pp_kernel :2155) and the same computation in its other TPU
// layouts (fused_gd_iteration_db / _db_padded / _fold / _fold_padded /
// _stacked, fused_gd_step). Per iteration (solver.estimate_psi's XLA step):
//   grad  = central difference of tnp, 0 on each axis's boundary slices
//   lap   = -(second differences of psi), per-axis term 0 on its boundary
//   dU    = (tnp - tg) * grad + w_reg * lap
//   dU_S  = conv_x(dU) + conv_y(dU) + conv_z(dU)    (replicate edges)
//   v'    = mu * v + dU_S                           (with momentum)
//   psi'  = psi - alpha * (v' or dU_S)
//   tnp'  = trilinear(live, psi')                   (K-clamped or exact)
//   max ||alpha * (v' or dU_S)||^2                  (one float, atomicMax)
//
// Two launches. gd_potential writes dU to a scratch field; gd_update reads
// it back for the three axis convolutions (each output needs dU over a
// +-r cross, which crosses block boundaries), then updates, re-warps and
// reduces. psi' and tnp' go to the other buffers of a ping-pong pair:
// neighbouring blocks still read psi for the Laplacian.
//
// Bound on the H100: memory. At 128^3 gd_potential moves ~67 MB (psi,
// tnp, tg in; dU out) and gd_update ~92 MB of compulsory traffic (dU, psi
// in; the live gather; psi', tnp' out). gd_potential runs near the
// bandwidth bound; gd_update is bound by its 63 convolution taps per voxel,
// gathered along y and z and re-read from L2 (H100 SXM 80 GB at 700 W:
// 29.9 us and 122.9 us per launch). Design: one thread per voxel, x
// fastest, so every volume pass is coalesced. Staging the convolution halo
// in shared memory, and fusing the two launches through it, is later work.
#include "sampling.cuh"

namespace sobfu {

__global__ void gd_potential_kernel(const float* __restrict__ psi,
                                    const float* __restrict__ tnp,
                                    const float* __restrict__ tg, float w_reg,
                                    float* __restrict__ dU, unsigned int* max_bits,
                                    int Z, int Y, int X) {
  const long long N = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *max_bits = 0u;  // read by gd_update, launched after this kernel
  if (i >= N) return;
  const int x = (int)(i % X);
  const int y = (int)((i / X) % Y);
  const int z = (int)(i / ((long long)X * Y));
  const long long sy = X, sz = (long long)X * Y;
  const bool in_x = x > 0 && x < X - 1;
  const bool in_y = y > 0 && y < Y - 1;
  const bool in_z = z > 0 && z < Z - 1;

  const float gx = in_x ? (tnp[i + 1] - tnp[i - 1]) * 0.5f : 0.0f;
  const float gy = in_y ? (tnp[i + sy] - tnp[i - sy]) * 0.5f : 0.0f;
  const float gz = in_z ? (tnp[i + sz] - tnp[i - sz]) * 0.5f : 0.0f;
  const float diff = tnp[i] - tg[i];
  const float grad[3] = {gx, gy, gz};
  for (int c = 0; c < 3; ++c) {
    const float* p = psi + c * N;
    const float pc = p[i];
    const float sdx = in_x ? (p[i + 1] + p[i - 1]) - 2.0f * pc : 0.0f;
    const float sdy = in_y ? (p[i + sy] + p[i - sy]) - 2.0f * pc : 0.0f;
    const float sdz = in_z ? (p[i + sz] + p[i - sz]) - 2.0f * pc : 0.0f;
    const float lap = -((sdx + sdy) + sdz);
    dU[c * N + i] = diff * grad[c] + w_reg * lap;
  }
}

__global__ void gd_update_kernel(const float* __restrict__ psi,
                                 const float* __restrict__ vel,
                                 const float* __restrict__ live,
                                 const float* __restrict__ dU,
                                 const float* __restrict__ taps, int n_taps, float alpha,
                                 float momentum, float* __restrict__ psi_out,
                                 float* __restrict__ tnp_out, float* __restrict__ vel_out,
                                 unsigned int* max_bits, int Z, int Y, int X, int K,
                                 float hi) {
  const long long N = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float n2 = 0.0f;
  if (i < N) {
    const int x = (int)(i % X);
    const int y = (int)((i / X) % Y);
    const int z = (int)(i / ((long long)X * Y));
    const int r = n_taps / 2;
    const long long row = i - x;                           // (z, y, 0)
    const long long col = (long long)z * Y * X + x;        // (z, 0, x)
    const long long pil = (long long)y * X + x;            // (0, y, x)
    float p_new[3], upd[3];
    for (int c = 0; c < 3; ++c) {
      const float* f = dU + c * N;
      float cx = 0.0f, cy = 0.0f, cz = 0.0f;
      for (int u = 0; u < n_taps; ++u) {
        const float w = __ldg(taps + u);
        const int xs = min(max(x + r - u, 0), X - 1);
        const int ys = min(max(y + r - u, 0), Y - 1);
        const int zs = min(max(z + r - u, 0), Z - 1);
        cx = cx + w * __ldg(f + row + xs);
        cy = cy + w * __ldg(f + col + (long long)ys * X);
        cz = cz + w * __ldg(f + pil + (long long)zs * Y * X);
      }
      const float dus = (cx + cy) + cz;
      float step = dus;
      if (vel != nullptr) {
        step = momentum * vel[c * N + i] + dus;
        vel_out[c * N + i] = step;
      }
      upd[c] = alpha * step;
      p_new[c] = psi[c * N + i] - upd[c];
      psi_out[c * N + i] = p_new[c];
    }
    n2 = (upd[0] * upd[0] + upd[1] * upd[1]) + upd[2] * upd[2];
    const Taps3 t = taps3(p_new[0], p_new[1], p_new[2], x, y, z, Z, Y, X, K, hi);
    tnp_out[i] = trilinear(t, K < 0, [&](int xi, int yi, int zi) {
      return __ldg(live + flat_index(xi, yi, zi, Y, X));
    });
  }
  block_max_atomic(n2, max_bits);
}

}  // namespace sobfu

// psi, dU, psi_out f32[3,Z,Y,X]; tnp, tg, live, tnp_out f32[Z,Y,X];
// vel, vel_out f32[3,Z,Y,X] or both null (no momentum); taps f32[n_taps];
// max_bits: one float, the max squared update norm; K < 0 = exact warp.
extern "C" int sobfu_gd_iteration(const float* psi, const float* tnp, const float* vel,
                                  const float* tg, const float* live, const float* taps,
                                  int n_taps, float alpha, float w_reg, float momentum,
                                  float* dU, float* psi_out, float* tnp_out, float* vel_out,
                                  float* max_sq, int Z, int Y, int X, int K, void* stream) {
  const long long N = (long long)Z * Y * X;
  const float hi = (float)((double)K - 1e-4);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* max_bits = reinterpret_cast<unsigned int*>(max_sq);
  sobfu::gd_potential_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0, s>>>(
      psi, tnp, tg, w_reg, dU, max_bits, Z, Y, X);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sobfu::gd_update_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0, s>>>(
      psi, vel, live, dU, taps, n_taps, alpha, momentum, psi_out, tnp_out, vel_out,
      max_bits, Z, Y, X, K, hi);
  return (int)cudaGetLastError();
}
