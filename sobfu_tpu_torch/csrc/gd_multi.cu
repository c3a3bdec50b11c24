// Kernel E: n_inner Sobolev gradient-descent iterations in ONE launch.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py fused_gd_multi_fold (:2805, body
// _make_multi_fold_kernel :2675), the pyramid's coarse-level kernel: on the
// TPU it keeps the whole 64^3 loop state in VMEM for 16 iterations per
// launch. Each iteration is kernel A's math (gd_step.cuh, the same device
// functions), so E equals n_inner chained A launches bit for bit: state,
// velocity, every max-norm row and every energy row.
//
// Design: a cooperative persistent kernel.
//   - cudaLaunchCooperativeKernel with a grid of (blocks per SM from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor) x (SM count), capped
//     at the number of tiles, so every block is resident and the grid can
//     synchronise;
//   - grid-stride loops over tiles of kBlock voxels (thread t of a block
//     takes voxel tile * kBlock + t, as in A);
//   - cooperative_groups::this_grid().sync() between the potential phase
//     (dU, and the verbose energies' tile sums) and the update phase, and
//     between iterations;
//   - a ping-pong pair of state buffers (psi, tnp, vel): iteration it reads
//     one and writes the other, the first reads the inputs (left untouched)
//     and the last writes the outputs.
// Per-iteration reductions go to row `it` of their outputs: the max norm by
// atomicMax on row it (all rows zeroed by block 0 before the first grid
// sync, so before any block's atomic), the energies as tile partials summed
// by block 0 in a fixed order after the next grid sync. Nothing accumulates
// across iterations.
//
// Where the state lives: at 64^3 psi, vel and dU are 3 MB each and tnp, tg
// and live 1 MB each, with the ping-pong copies about 14 MB in all. That
// fits in the H100's 50 MB L2, the analogue of the TPU kernel's VMEM
// residency: after the first iteration the loop runs out of L2.
//
// Bound on the H100: at 64^3 an iteration of A is ~20 us of device work in
// three launches, so launch gaps and the host's wrapper calls weigh as much
// as the work; E removes them (H100 SXM 80 GB at 700 W, 16 iterations:
// 0.519 ms per E launch against 0.746 ms for 16 chained A launches). E's
// own device time is ~29 us per iteration: 80 registers a thread allow 3
// blocks per SM (A's bodies alone: 40), and each iteration waits at two
// grid syncs. Within an iteration the bound is A's: the 63 convolution
// taps per voxel. No shared-memory staging yet — a simple right kernel first.
#include <cooperative_groups.h>

#include "gd_step.cuh"

namespace cg = cooperative_groups;

namespace sobfu {

struct MultiArgs {
  const float* psi_in;
  const float* tnp_in;
  const float* vel_in;  // null without momentum
  const float* tg;
  const float* live;
  const float* taps;
  float* psi_out;  // written by the last iteration
  float* tnp_out;
  float* vel_out;
  float* psi_tmp;  // the other half of the ping-pong pair
  float* tnp_tmp;
  float* vel_tmp;
  float* dU;
  float* mx_sq;   // [n_inner]
  float* e_data;  // [n_inner] or null
  float* e_pre;   // [n_inner] or null (verbose)
  float* e_reg;   // [n_inner] or null (verbose)
  float* part_data;  // [n_tiles] tile partials
  float* part_pre;
  float* part_reg;
  float alpha, w_reg, momentum, hi;
  int n_taps, n_inner, Z, Y, X, K;
};

__global__ void __launch_bounds__(kBlock) gd_multi_kernel(MultiArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long N = (long long)a.Z * a.Y * a.X;
  const long long n_tiles = (N + kBlock - 1) / kBlock;
  const bool has_vel = a.vel_in != nullptr;
  const bool verbose = a.e_pre != nullptr;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int it = 0; it < a.n_inner; ++it) a.mx_sq[it] = 0.0f;
  }
  const float* psi = a.psi_in;
  const float* tnp = a.tnp_in;
  const float* vel = a.vel_in;
  for (int it = 0; it < a.n_inner; ++it) {
    const bool to_out = (a.n_inner - 1 - it) % 2 == 0;
    float* psi_new = to_out ? a.psi_out : a.psi_tmp;
    float* tnp_new = to_out ? a.tnp_out : a.tnp_tmp;
    float* vel_new = has_vel ? (to_out ? a.vel_out : a.vel_tmp) : nullptr;

    // phase 1: dU (and the pre-update energies' tile sums)
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long i = tile * kBlock + threadIdx.x;
      float e_sq = 0.0f, j_sq = 0.0f;
      if (i < N) {
        gd_potential_voxel(i, psi, tnp, a.tg, a.w_reg, a.dU, a.Z, a.Y, a.X);
        if (verbose) verbose_voxel(i, psi, tnp, a.tg, a.Z, a.Y, a.X, &e_sq, &j_sq);
      }
      if (verbose) {
        const float se = block_sum(e_sq);
        const float sj = block_sum(j_sq);
        if (threadIdx.x == 0) {
          a.part_pre[tile] = se;
          a.part_reg[tile] = sj;
        }
      }
    }
    grid.sync();
    if (verbose && blockIdx.x == 0) {
      const float se = sum_partials(a.part_pre, n_tiles);
      const float sj = sum_partials(a.part_reg, n_tiles);
      if (threadIdx.x == 0) {
        a.e_pre[it] = 0.5f * se;
        a.e_reg[it] = 0.5f * sj;
      }
    }

    // phase 2: convolutions, update, re-warp, max norm (and the data energy)
    unsigned int* max_bits = reinterpret_cast<unsigned int*>(a.mx_sq + it);
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      gd_update_tile(tile, psi, vel, a.live, a.dU, a.taps, a.n_taps, a.alpha, a.momentum,
                     psi_new, tnp_new, vel_new, a.tg, max_bits,
                     a.e_data != nullptr ? a.part_data : nullptr, a.Z, a.Y, a.X, a.K, a.hi);
    }
    grid.sync();
    if (a.e_data != nullptr && blockIdx.x == 0) {
      const float s = sum_partials(a.part_data, n_tiles);
      if (threadIdx.x == 0) a.e_data[it] = 0.5f * s;
    }
    psi = psi_new;
    tnp = tnp_new;
    vel = vel_new;
  }
}

}  // namespace sobfu

// psi_in, psi_out, psi_tmp, dU f32[3,Z,Y,X]; tnp_in, tnp_out, tnp_tmp, tg,
// live f32[Z,Y,X]; vel_in, vel_out, vel_tmp f32[3,Z,Y,X] or all null (no
// momentum); taps f32[n_taps]; mx_sq f32[n_inner]; e_data, e_pre, e_reg
// f32[n_inner] or null; part_data (with e_data), part_pre and part_reg
// (with e_pre / e_reg) f32[ceil(Z*Y*X / 256)] or null; K < 0 = exact warp.
// Returns cudaErrorNotSupported when the device has no cooperative launch.
extern "C" int sobfu_gd_multi(const float* psi_in, const float* tnp_in, const float* vel_in,
                              const float* tg, const float* live, const float* taps,
                              int n_taps, float alpha, float w_reg, float momentum,
                              float* psi_out, float* tnp_out, float* vel_out, float* psi_tmp,
                              float* tnp_tmp, float* vel_tmp, float* dU, float* mx_sq,
                              float* e_data, float* e_pre, float* e_reg, float* part_data,
                              float* part_pre, float* part_reg, int n_inner, int Z, int Y,
                              int X, int K, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int coop = 0, n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sobfu::gd_multi_kernel,
                                                      sobfu::kBlock, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long N = (long long)Z * Y * X;
  const long long n_tiles = (N + sobfu::kBlock - 1) / sobfu::kBlock;
  const long long cap = (long long)per_sm * n_sm;
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);

  sobfu::MultiArgs a;
  a.psi_in = psi_in;
  a.tnp_in = tnp_in;
  a.vel_in = vel_in;
  a.tg = tg;
  a.live = live;
  a.taps = taps;
  a.psi_out = psi_out;
  a.tnp_out = tnp_out;
  a.vel_out = vel_out;
  a.psi_tmp = psi_tmp;
  a.tnp_tmp = tnp_tmp;
  a.vel_tmp = vel_tmp;
  a.dU = dU;
  a.mx_sq = mx_sq;
  a.e_data = e_data;
  a.e_pre = e_pre;
  a.e_reg = e_reg;
  a.part_data = part_data;
  a.part_pre = part_pre;
  a.part_reg = part_reg;
  a.alpha = alpha;
  a.w_reg = w_reg;
  a.momentum = momentum;
  a.hi = (float)((double)K - 1e-4);
  a.n_taps = n_taps;
  a.n_inner = n_inner;
  a.Z = Z;
  a.Y = Y;
  a.X = X;
  a.K = K;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)sobfu::gd_multi_kernel, dim3(grid),
                                    dim3(sobfu::kBlock), params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
