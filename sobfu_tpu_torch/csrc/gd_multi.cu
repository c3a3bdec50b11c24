// Kernel E: n_inner Sobolev gradient-descent iterations in ONE launch, and
// the coarse pyramid level's loop as launches that test its stop rule on
// the card.
//
// Replaces sobfu_tpu/ops/pallas_kernels.py fused_gd_multi_fold (:2805, body
// _make_multi_fold_kernel :2675), the pyramid's coarse-level kernel: on the
// TPU it keeps the whole 64^3 loop state in VMEM for 16 iterations per
// launch, and JAX runs it in a lax.while_loop that tests the chunk's last
// norm (and, at a stall check, its last energy) with no host read
// (sobfu_tpu/solver.py:337-345, 506-540).
//
// Bound on the H100: at 64^3 an iteration must read psi, vel, tnp, tg and
// live and write psi', vel', tnp' (~14 MB, 0.004 ms at 3.35 TB/s), and it
// does 267 float operations a voxel (0.001 ms at 67 TFLOP/s); sixteen
// iterations 0.0167 ms by operations. What it pays beyond that is the
// latency of kernel A's z-march, a chain of dependent steps.
//
// Design: a cooperative persistent kernel over kernel A's march.
//   - Every iteration is csrc/gd_step.cuh's gd_march, kernel A's body: dU
//     in a shared-memory ring of n_taps + 1 planes, the replicate edge
//     clamped once per thread, the same arithmetic in the same order. So E
//     equals n_inner chained A launches bit for bit: state, velocity, every
//     max-norm row and every energy row. dU never reaches device memory.
//   - The coarse level of the 128^3 and 256^3 pyramids is 64^3 with 7 taps
//     and 2-plane segments: that case runs an instantiation whose strides
//     and segment length are constants (the march unrolled); any other
//     grid or segment length runs the generic one.
//   - cudaLaunchCooperativeKernel with a grid of (blocks per SM from the
//     occupancy query, with the ring's dynamic shared memory) x (SM count),
//     capped at the number of segments; a block marches its segments in
//     turn. A launch that cannot be resident returns its CUDA error.
//   - ONE grid sync an iteration: iteration it + 1 reads psi' and tnp' of
//     neighbouring tiles. The state ping-pongs between two buffers in
//     device memory (14 MB at 64^3, inside the 50 MB L2); psi, tnp and vel
//     are written during the launch, so they are read with plain loads,
//     never through the read-only path.
//   - The max norm of each iteration goes to its own row by atomicMax. The
//     data energy of a row is the fixed-order sum of the 256-voxel tile
//     partials that A's energy pass forms, made for the rows asked for
//     only: the tiles of iteration it's result are summed in the phase
//     before iteration it + 1's march (the same values as the verbose
//     pre-update energy of it + 1), block 0 sums them after the next grid
//     sync; the last row costs one more pass and grid sync. Two partial
//     buffers alternate, so block 0 reads one while the grid writes the
//     other.
//
// The loop (sobfu_gd_multi with n_launch > 1): row k of ctl holds {the
// iterations done before launch k, running (1/0), stalled (1/0), the stall
// reference energy's bits}. Launch k runs iff the row says running, the
// count is under max_iter, and, for k > 0, launch k - 1's last norm passes
// __fsqrt_rn(max_sq) > thresh (the host's f32 test bit for bit). The test
// comes before the first grid sync; a launch that fails it leaves at once,
// grid-uniformly, writes nothing but its ctl row. A launch that ends on a
// stall check (count % stall_window == 0) forms its last energy and decides
// e_ref - e_now < stall_rel * |e_now| with __fsub_rn / __fmul_rn, as
// solver.stall_check does in numpy float32. Iteration c reads buffer c & 1.
//
// Measured on an H100 80GB HBM3 at 700 W, 64^3, 7 taps, K=1, momentum 0.95,
// device time per launch of 16 iterations (torch.profiler; parent and
// variants in turns, tools/bench_torch_kernels.py --root): the kernel
// before (global-memory bodies, dU in device memory, two grid syncs an
// iteration, 80 registers, 3 blocks an SM) 0.426-0.437. This form on any
// grid, by the segment length LZ (kernels.GD_MULTI_MIN_LZ): 2 planes (512
// blocks, 4 an SM, 64 registers, 56 bytes of spills) 0.407-0.430; 4 (256
// blocks) 0.459-0.493; 8 (128) 0.659-0.674 — a segment marches LZ + 2r + 1
// dependent plane steps whatever LZ is, and fewer blocks hide less of them.
// A 64^3 instantiation with every stride a constant (the fill's 29 loads a
// position become immediate offsets from two pointers; 4 bytes of spills):
// 0.379-0.394 at LZ 2, 0.441-0.442 at LZ 4, 0.610-0.626 at LZ 8. With the
// segment length a constant too (the march unrolled, 9 plane steps; 8 / 24
// bytes of spill stores / loads), kept: 0.3257-0.3260, and 0.3222-0.3225 a
// launch through kernels.GdMultiLoop. Tried and dropped,
// on the generic form: __launch_bounds__(256, 3) (85 registers, no spills,
// 3 blocks an SM): 0.536 at LZ 2, 0.414 at LZ 4; the state read through the
// read-only path (wrong in principle, for timing only): 0.436-0.441, so the
// plain loads cost nothing; 32-bit voxel offsets from per-channel bases
// instead of 64-bit pointer strides in the fill: 0.435-0.439, and A over
// scenes 13% slower. An iteration costs what kernel A's launch of the same
// plan costs plus ~1 us of grid sync: at 64^3 E saves A's launch gaps and
// the host's reads more than device time; the march itself bounds both (its
// generic fill is ~200 instructions a dU position, 2.5-5 positions a voxel).
#include <cooperative_groups.h>

#include "gd_step.cuh"

namespace cg = cooperative_groups;

namespace sobfu {

struct MultiArgs {
  const float* psi_in;  // the state iteration 0 reads; null: the pair's buffer
  const float* tnp_in;
  const float* vel_in;
  float* psi[2];  // the ping-pong pair: iteration c reads [c & 1]
  float* tnp[2];
  float* vel[2];  // both null without momentum
  const float* tg;
  const float* live;
  const float* taps;
  const int* ctl_in;             // [4] row k; null: one launch from count 0, no test
  int* ctl_out;                  // [4] row k + 1
  const unsigned int* prev_max;  // launch k - 1's last norm row; null for k = 0
  unsigned int* max_bits;        // [n_inner]
  float* e_data;                 // [n_inner] or null
  float* e_pre;                  // [n_inner] or null (verbose)
  float* e_reg;
  float* parts;  // [2][n_tiles] data-energy partials, then [2][n_tiles] regulariser ones
  MarchShape m;
  float thresh, stall_rel;
  int n_inner, max_iter, stall_window;
  int energy_every;  // every row of e_data; else the last, where the launch ends on a check
};

// The tile partials of the data energy (tg - tnp)^2 and, verbose, of the
// regulariser ||J||^2 over tiles of 256 consecutive voxels, the grid
// striding over the tiles (kernel A's energy pass, E's verbose rows).
__device__ __forceinline__ void tile_energies(const float* psi, const float* tnp,
                                              const float* tg, bool verbose, float* pe,
                                              float* pj, int n_tiles, const MarchShape& m) {
  const long long N = (long long)m.Z * m.Y * m.X;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i = (long long)tile * kBlock + threadIdx.x;
    float e_sq = 0.0f, j_sq = 0.0f;
    if (i < N) {
      if (verbose) {
        verbose_voxel(i, psi, tnp, tg, m.Z, m.Y, m.X, &e_sq, &j_sq);
      } else {
        const float d = tg[i] - tnp[i];
        e_sq = d * d;
      }
    }
    const float se = block_sum(e_sq);
    const float sj = verbose ? block_sum(j_sq) : 0.0f;
    if (threadIdx.x == 0) {
      pe[tile] = se;
      if (verbose) pj[tile] = sj;
    }
  }
}

template <int NT, int kCube, int kLZ>
__global__ void __launch_bounds__(kBlock, 4) gd_multi_kernel(const MultiArgs a) {
  extern __shared__ float ring[];  // [3][NT + 1][kTileY + 2r][kTileX + 2r]
  const MarchShape& m = a.m;
  // the stop test, before any grid sync: every block reads the same words
  int c0 = 0;
  if (a.ctl_in != nullptr) {
    c0 = a.ctl_in[0];
    bool on = a.ctl_in[1] != 0 && c0 < a.max_iter;
    if (on && a.prev_max != nullptr) on = __fsqrt_rn(__uint_as_float(*a.prev_max)) > a.thresh;
    if (!on) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.ctl_out[0] = c0;
        a.ctl_out[1] = 0;
        a.ctl_out[2] = a.ctl_in[2];
        a.ctl_out[3] = a.ctl_in[3];
      }
      return;
    }
  }
  cg::grid_group grid = cg::this_grid();
  const int n = a.n_inner;
  const int n_tiles = (int)(((long long)m.Z * m.Y * m.X + kBlock - 1) / kBlock);
  const int n_segs = m.tiles_x * m.tiles_y * m.segs;
  const bool verbose = a.e_pre != nullptr;
  const bool check = a.stall_window > 0 && (c0 + n) % a.stall_window == 0;
  float* pe[2] = {a.parts, a.parts + n_tiles};
  float* pj[2] = {a.parts + 2 * n_tiles, a.parts + 3 * n_tiles};
  auto energy_row = [&](int it) {
    return a.e_data != nullptr && (a.energy_every || (check && it == n - 1));
  };
  float w[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) w[u] = __ldg(a.taps + u);

  for (int it = 0; it < n; ++it) {
    const int par = (c0 + it) & 1;
    const bool first = it == 0 && a.psi_in != nullptr;
    MarchIO io;
    io.psi = first ? a.psi_in : a.psi[par];
    io.tnp = first ? a.tnp_in : a.tnp[par];
    io.vel = a.vel[0] == nullptr ? nullptr : first ? a.vel_in : a.vel[par];
    io.tg = a.tg;
    io.live = a.live;
    io.psi_out = a.psi[par ^ 1];
    io.tnp_out = a.tnp[par ^ 1];
    io.vel_out = a.vel[par ^ 1];
    // the energies of the state this iteration reads: iteration it - 1's
    // data energy and this one's verbose pre-update rows
    const bool e_prev = it > 0 && energy_row(it - 1);
    if (e_prev || verbose)
      tile_energies(io.psi, io.tnp, a.tg, verbose, pe[it & 1], pj[it & 1], n_tiles, m);
    float n2 = 0.0f;
    for (int b = blockIdx.x; b < n_segs; b += gridDim.x)
      n2 = nan_max(gd_march<NT, false, kCube, kLZ>(io, w, ring, segment<kCube>(b, m), m), n2);
    block_max_atomic(n2, a.max_bits + it);
    grid.sync();
    if (blockIdx.x == 0 && (e_prev || verbose)) {
      const float se = sum_partials(pe[it & 1], n_tiles);
      const float sj = verbose ? sum_partials(pj[it & 1], n_tiles) : 0.0f;
      if (threadIdx.x == 0) {
        if (e_prev) a.e_data[it - 1] = 0.5f * se;
        if (verbose) {
          a.e_pre[it] = 0.5f * se;
          a.e_reg[it] = 0.5f * sj;
        }
      }
    }
  }

  float e_last = 0.0f;  // valid in block 0, thread 0
  if (energy_row(n - 1)) {
    const int par = (c0 + n) & 1;  // the buffer the last iteration wrote
    tile_energies(a.psi[par], a.tnp[par], a.tg, false, pe[n & 1], nullptr, n_tiles, m);
    grid.sync();
    if (blockIdx.x == 0) {
      const float se = sum_partials(pe[n & 1], n_tiles);
      if (threadIdx.x == 0) a.e_data[n - 1] = e_last = 0.5f * se;
    }
  }
  if (a.ctl_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    const int c1 = c0 + n;
    float e_ref = __int_as_float(a.ctl_in[3]);
    bool stalled = false;
    if (check) {
      stalled = c1 >= 2 * a.stall_window &&
                __fsub_rn(e_ref, e_last) < __fmul_rn(a.stall_rel, fabsf(e_last));
      e_ref = e_last;
    }
    a.ctl_out[0] = c1;
    a.ctl_out[1] = stalled ? 0 : 1;
    a.ctl_out[2] = stalled ? 1 : 0;
    a.ctl_out[3] = __float_as_int(e_ref);
  }
}

template <int NT, int kCube = 0, int kLZ = 0>
int gd_multi_launch(MultiArgs a, int* ctl, float* max_sq, int n_launch, cudaStream_t st) {
  constexpr int r = NT / 2;
  const size_t smem = sizeof(float) * 3 * (NT + 1) * (kTileY + 2 * r) * (kTileX + 2 * r);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = (const void*)gd_multi_kernel<NT, kCube, kLZ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n_segs = a.m.tiles_x * a.m.tiles_y * a.m.segs;
  const int grid = n_segs < per_sm * n_sm ? n_segs : per_sm * n_sm;
  err = cudaMemsetAsync(max_sq, 0, sizeof(float) * n_launch * a.n_inner, st);
  if (err != cudaSuccess) return (int)err;
  unsigned int* rows = reinterpret_cast<unsigned int*>(max_sq);
  float* e_data = a.e_data;
  for (int k = 0; k < n_launch; ++k) {
    if (ctl != nullptr) {
      a.ctl_in = ctl + 4 * k;
      a.ctl_out = ctl + 4 * (k + 1);
    }
    a.prev_max = k > 0 ? rows + (size_t)k * a.n_inner - 1 : nullptr;
    a.max_bits = rows + (size_t)k * a.n_inner;
    a.e_data = e_data != nullptr ? e_data + (size_t)k * a.n_inner : nullptr;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kBlock), params, smem, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace sobfu

// n_launch launches of n_inner iterations each. psi0/psi1, vel0/vel1
// f32[3,Z,Y,X] and tnp0/tnp1 f32[Z,Y,X] are the ping-pong pair (vel0 and
// vel1 both null without momentum); psi_in, tnp_in, vel_in, if set, the
// state that iteration 0 of launch 0 reads instead of the pair's buffer
// (with ctl null). tg, live f32[Z,Y,X]; taps f32[n_taps], n_taps odd <= 11.
// ctl i32[n_launch + 1, 4] or null: the caller sets row 0 ({count, 1, 0,
// e_ref bits}: count iterations done, the state in buffer count & 1),
// rows 1..n_launch are written here; null runs one launch from count 0
// with no stop test. max_sq f32[n_launch, n_inner]: each iteration's max
// squared update norm, 0 where a launch did not run. e_data f32[n_launch,
// n_inner] or null: energy_every != 0 fills every row, else the last row
// of a launch that ends on a stall check (needed when stall_window > 0).
// e_pre, e_reg f32[n_inner] or null: the verbose pre-update energies
// (n_launch = 1). parts f32[4 * ceil(Z*Y*X / 256)], or null with neither
// energies nor verbose rows. LZ is a block's z segment (the tile is 8 x
// 32). K < 0 = exact warp. Z*Y*X < 2^31.
extern "C" int sobfu_gd_multi(const float* psi_in, const float* tnp_in, const float* vel_in,
                              float* psi0, float* psi1, float* tnp0, float* tnp1, float* vel0,
                              float* vel1, const float* tg, const float* live, const float* taps,
                              int n_taps, float alpha, float w_reg, float momentum, float thresh,
                              int max_iter, int stall_window, float stall_rel, int* ctl,
                              float* max_sq, float* e_data, int energy_every, float* e_pre,
                              float* e_reg, float* parts, int n_inner, int n_launch, int Z, int Y,
                              int X, int K, int LZ, void* stream) {
  using namespace sobfu;
  const long long N = (long long)Z * Y * X;
  if (n_inner < 1 || n_launch < 1 || N < 1 || N >= (1ll << 31) || LZ < 1 ||
      (ctl == nullptr && n_launch != 1) || (ctl != nullptr && psi_in != nullptr) ||
      (stall_window > 0 && (ctl == nullptr || e_data == nullptr)) ||
      (e_pre != nullptr && n_launch != 1) ||
      ((e_data != nullptr || e_pre != nullptr) && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  MultiArgs a;
  a.psi_in = psi_in, a.tnp_in = tnp_in, a.vel_in = vel_in;
  a.psi[0] = psi0, a.psi[1] = psi1;
  a.tnp[0] = tnp0, a.tnp[1] = tnp1;
  a.vel[0] = vel0, a.vel[1] = vel1;
  a.tg = tg, a.live = live, a.taps = taps;
  a.ctl_in = nullptr, a.ctl_out = nullptr;
  a.e_data = e_data, a.e_pre = e_pre, a.e_reg = e_reg, a.parts = parts;
  a.m = march_shape(Z, Y, X, K, LZ, alpha, w_reg, momentum);
  a.thresh = thresh, a.stall_rel = stall_rel;
  a.n_inner = n_inner, a.max_iter = max_iter, a.stall_window = stall_window;
  a.energy_every = energy_every;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_taps) {
    case 1: return gd_multi_launch<1>(a, ctl, max_sq, n_launch, st);
    case 3: return gd_multi_launch<3>(a, ctl, max_sq, n_launch, st);
    case 5: return gd_multi_launch<5>(a, ctl, max_sq, n_launch, st);
    case 7:  // the coarse level of the 128^3 and 256^3 pyramids: every stride a constant
      if (Z == 64 && Y == 64 && X == 64 && LZ == 2)
        return gd_multi_launch<7, 64, 2>(a, ctl, max_sq, n_launch, st);
      return gd_multi_launch<7>(a, ctl, max_sq, n_launch, st);
    case 9: return gd_multi_launch<9>(a, ctl, max_sq, n_launch, st);
    case 11: return gd_multi_launch<11>(a, ctl, max_sq, n_launch, st);
  }
  return (int)cudaErrorInvalidValue;
}
