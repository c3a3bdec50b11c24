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
//   e     = 0.5 * sum (tg - tnp')^2                 (optional: the stall
//           detector's data energy, fused_gd_iteration_pp with_energy)
//
// Two launches, three with the energy. gd_potential writes dU to a scratch
// field; gd_update reads it back for the three axis convolutions (each
// output needs dU over a +-r cross, which crosses block boundaries), then
// updates, re-warps and reduces. psi' and tnp' go to the other buffers of a
// ping-pong pair: neighbouring blocks still read psi for the Laplacian. The
// energy is reduced deterministically: each block writes its tile's sum to
// a partials array, and one block adds the partials in a fixed order
// (gd_step.cuh) — no float atomics, so a stall decision is the same on
// every run. The bodies live in gd_step.cuh, shared with kernel E.
//
// Bound on the H100: memory. At 128^3 gd_potential moves ~67 MB (psi,
// tnp, tg in; dU out) and gd_update ~92 MB of compulsory traffic (dU, psi
// in; the live gather; psi', tnp' out). gd_potential runs near the
// bandwidth bound; gd_update is bound by its 63 convolution taps per voxel,
// gathered along y and z and re-read from L2 (H100 SXM 80 GB at 700 W:
// 29.9 us and 122.9 us per launch). Design: one thread per voxel, x
// fastest, so every volume pass is coalesced. Staging the convolution halo
// in shared memory, and fusing the two launches through it, is later work.
#include "gd_step.cuh"

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
  gd_potential_voxel(i, psi, tnp, tg, w_reg, dU, Z, Y, X);
}

__global__ void gd_update_kernel(const float* __restrict__ psi,
                                 const float* __restrict__ vel,
                                 const float* __restrict__ live,
                                 const float* __restrict__ dU,
                                 const float* __restrict__ taps, int n_taps, float alpha,
                                 float momentum, float* __restrict__ psi_out,
                                 float* __restrict__ tnp_out, float* __restrict__ vel_out,
                                 const float* __restrict__ tg, unsigned int* max_bits,
                                 float* e_partials, int Z, int Y, int X, int K, float hi) {
  gd_update_tile(blockIdx.x, psi, vel, live, dU, taps, n_taps, alpha, momentum, psi_out,
                 tnp_out, vel_out, tg, max_bits, e_partials, Z, Y, X, K, hi);
}

// 0.5 * the sum of n tile partials, by one block in a fixed order.
__global__ void energy_final_kernel(const float* __restrict__ partials, long long n,
                                    float* __restrict__ out) {
  const float s = sum_partials(partials, n);
  if (threadIdx.x == 0) *out = 0.5f * s;
}

}  // namespace sobfu

// psi, dU, psi_out f32[3,Z,Y,X]; tnp, tg, live, tnp_out f32[Z,Y,X];
// vel, vel_out f32[3,Z,Y,X] or both null (no momentum); taps f32[n_taps];
// max_sq: one float, the max squared update norm; e_partials
// f32[ceil(Z*Y*X / 256)] and e_data (one float) or both null (no energy);
// K < 0 = exact warp.
extern "C" int sobfu_gd_iteration(const float* psi, const float* tnp, const float* vel,
                                  const float* tg, const float* live, const float* taps,
                                  int n_taps, float alpha, float w_reg, float momentum,
                                  float* dU, float* psi_out, float* tnp_out, float* vel_out,
                                  float* max_sq, float* e_partials, float* e_data, int Z,
                                  int Y, int X, int K, void* stream) {
  const long long N = (long long)Z * Y * X;
  const float hi = (float)((double)K - 1e-4);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* max_bits = reinterpret_cast<unsigned int*>(max_sq);
  const int n_blocks = sobfu::blocks_for(N);
  sobfu::gd_potential_kernel<<<n_blocks, sobfu::kBlock, 0, s>>>(psi, tnp, tg, w_reg, dU,
                                                                max_bits, Z, Y, X);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sobfu::gd_update_kernel<<<n_blocks, sobfu::kBlock, 0, s>>>(
      psi, vel, live, dU, taps, n_taps, alpha, momentum, psi_out, tnp_out, vel_out, tg,
      max_bits, e_partials, Z, Y, X, K, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || e_partials == nullptr) return (int)err;
  sobfu::energy_final_kernel<<<1, sobfu::kBlock, 0, s>>>(e_partials, n_blocks, e_data);
  return (int)cudaGetLastError();
}
