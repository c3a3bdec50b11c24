// Kernel A: one Sobolev gradient-descent iteration of the warp-field solve.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py fused_gd_iteration_pp (:2443,
// body _make_pp_kernel :2155) and the same computation in its other TPU
// layouts (fused_gd_iteration_db / _fold / _fold_padded / _stacked,
// fused_gd_step), and over a leading scene axis fused_gd_iteration_db_padded
// (:1075, call :1208), the per-scene kernel of the scene-batched frame step
// (sobfu_tpu/parallel/sharding.py make_frame_step, which runs it under
// jax.vmap of its GD while_loop). Per iteration (solver.estimate_psi's XLA
// step):
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
//
// Scenes: one entry point takes S >= 1 scenes as grid dimension y. Scene s
// reads and writes its slice of every volume (base offsets s*N and s*3N)
// through the same bodies, so scene s of a batch equals a one-scene launch
// on it bit for bit. A scene whose predicate is false (active[s] == 0) keeps
// its state, as the vmapped while_loop does: its tiles copy psi, tnp and vel
// through and report max_sq[s] = 0 (and a zero energy). One scene with no
// active mask (the unbatched A) runs the kScenes = false instantiation of
// the same kernels, with the scene index a constant 0: on the H100 the
// scene offsets and mask test cost the unbatched launch 10% of its device
// time at 128^3 (0.1702 against 0.1550 ms; PERF.md). The bound is S times
// A's (with momentum 64 bytes per voxel and scene: psi, vel, tnp, tg, live
// in; psi', vel', tnp' out); one launch serves all S, so the host pays one
// launch and one read of the S max norms per iteration instead of S.
#include "gd_step.cuh"

namespace sobfu {

// kScenes false: one scene, every offset 0 and no mask (gridDim.y == 1).
template <bool kScenes>
__device__ __forceinline__ int scene() {
  return kScenes ? (int)blockIdx.y : 0;
}

// active == nullptr: every scene runs.
template <bool kScenes>
__device__ __forceinline__ bool scene_on(const unsigned char* active, int s) {
  return !kScenes || active == nullptr || active[s] != 0;
}

template <bool kScenes>
__global__ void gd_potential_kernel(const float* __restrict__ psi,
                                    const float* __restrict__ tnp,
                                    const float* __restrict__ tg, float w_reg,
                                    float* __restrict__ dU, unsigned int* max_bits,
                                    const unsigned char* __restrict__ active, int Z, int Y,
                                    int X) {
  const long long N = (long long)Z * Y * X;
  const int s = scene<kScenes>();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) max_bits[s] = 0u;  // read by gd_update, launched after this kernel
  if (i >= N || !scene_on<kScenes>(active, s)) return;
  gd_potential_voxel(i, psi + 3 * N * s, tnp + N * s, tg + N * s, w_reg, dU + 3 * N * s, Z,
                     Y, X);
}

template <bool kScenes>
__global__ void gd_update_kernel(
    const float* __restrict__ psi, const float* __restrict__ vel,
    const float* __restrict__ live, const float* __restrict__ dU,
    const float* __restrict__ taps, int n_taps, float alpha, float momentum,
    float* __restrict__ psi_out, float* __restrict__ tnp_out, float* __restrict__ vel_out,
    const float* __restrict__ tnp, const float* __restrict__ tg, unsigned int* max_bits,
    float* e_partials, const unsigned char* __restrict__ active, int Z, int Y, int X, int K,
    float hi) {
  const long long N = (long long)Z * Y * X;
  const long long n_tiles = gridDim.x;
  const int s = scene<kScenes>();
  const long long f = 3 * N * s, v = N * s;  // the scene's field and volume offsets
  if (!scene_on<kScenes>(active, s)) {  // uniform over the block: the whole block leaves here
    const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (i < N) {
      for (int c = 0; c < 3; ++c) psi_out[f + c * N + i] = psi[f + c * N + i];
      if (vel != nullptr)
        for (int c = 0; c < 3; ++c) vel_out[f + c * N + i] = vel[f + c * N + i];
      tnp_out[v + i] = tnp[v + i];
    }
    if (e_partials != nullptr && threadIdx.x == 0) e_partials[n_tiles * s + blockIdx.x] = 0.0f;
    return;
  }
  gd_update_tile(blockIdx.x, psi + f, vel != nullptr ? vel + f : nullptr, live + v, dU + f,
                 taps, n_taps, alpha, momentum, psi_out + f, tnp_out + v,
                 vel_out != nullptr ? vel_out + f : nullptr, tg + v, max_bits + s,
                 e_partials != nullptr ? e_partials + n_tiles * s : nullptr, Z, Y, X, K, hi);
}

// 0.5 * the sum of n tile partials, by one block in a fixed order; block b
// sums the partials of scene b (n per scene) into out[b].
__global__ void energy_final_kernel(const float* __restrict__ partials, long long n,
                                    float* __restrict__ out) {
  const float s = sum_partials(partials + blockIdx.x * n, n);
  if (threadIdx.x == 0) out[blockIdx.x] = 0.5f * s;
}

template <bool kScenes>
int gd_iteration_launch(const float* psi, const float* tnp, const float* vel, const float* tg,
                        const float* live, const float* taps, int n_taps, float alpha,
                        float w_reg, float momentum, const unsigned char* active, float* dU,
                        float* psi_out, float* tnp_out, float* vel_out, float* max_sq,
                        float* e_partials, float* e_data, int S, int Z, int Y, int X, int K,
                        cudaStream_t stream) {
  const long long N = (long long)Z * Y * X;
  const float hi = (float)((double)K - 1e-4);
  unsigned int* max_bits = reinterpret_cast<unsigned int*>(max_sq);
  const int n_blocks = blocks_for(N);
  const dim3 grid(n_blocks, S);
  gd_potential_kernel<kScenes>
      <<<grid, kBlock, 0, stream>>>(psi, tnp, tg, w_reg, dU, max_bits, active, Z, Y, X);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gd_update_kernel<kScenes><<<grid, kBlock, 0, stream>>>(
      psi, vel, live, dU, taps, n_taps, alpha, momentum, psi_out, tnp_out, vel_out, tnp, tg,
      max_bits, e_partials, active, Z, Y, X, K, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || e_partials == nullptr) return (int)err;
  energy_final_kernel<<<S, kBlock, 0, stream>>>(e_partials, n_blocks, e_data);
  return (int)cudaGetLastError();
}

}  // namespace sobfu

// psi, vel, dU, psi_out, vel_out f32[S,3,Z,Y,X]; tnp, tg, live, tnp_out
// f32[S,Z,Y,X]; vel and vel_out both null without momentum; taps
// f32[n_taps]; active u8[S] (0 = the scene keeps its state) or null (every
// scene runs); max_sq f32[S], each scene's max squared update norm;
// e_partials f32[S, ceil(Z*Y*X / 256)] and e_data f32[S] or both null (no
// energy); K < 0 = exact warp. 1 <= S <= 65535.
extern "C" int sobfu_gd_iteration(
    const float* psi, const float* tnp, const float* vel, const float* tg, const float* live,
    const float* taps, int n_taps, float alpha, float w_reg, float momentum,
    const unsigned char* active, float* dU, float* psi_out, float* tnp_out, float* vel_out,
    float* max_sq, float* e_partials, float* e_data, int S, int Z, int Y, int X, int K,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 1 && active == nullptr)
    return sobfu::gd_iteration_launch<false>(psi, tnp, vel, tg, live, taps, n_taps, alpha,
                                             w_reg, momentum, active, dU, psi_out, tnp_out,
                                             vel_out, max_sq, e_partials, e_data, S, Z, Y, X,
                                             K, st);
  return sobfu::gd_iteration_launch<true>(psi, tnp, vel, tg, live, taps, n_taps, alpha, w_reg,
                                          momentum, active, dU, psi_out, tnp_out, vel_out,
                                          max_sq, e_partials, e_data, S, Z, Y, X, K, st);
}
