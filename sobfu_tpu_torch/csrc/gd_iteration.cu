// Kernel A: Sobolev gradient-descent iterations of the warp-field solve, one
// launch per iteration, n iterations per call with the stop test on the card.
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
// Bound on the H100: memory (at 128^3 84 MB must move: psi, tnp, tg, live in;
// psi', tnp' out; 0.025 ms at 3.35 TB/s). What the kernel pays beyond it is
// the convolution's 21 taps per channel and the dU they read. Design
// (gd_fused_kernel): dU never reaches device memory.
//   - A block owns a tile of 8 x 32 (y, x) voxels, one a thread, and marches
//     a segment of LZ planes along z. Shared memory holds a ring of n_taps
//     + 1 planes of dU (3 channels), each the tile plus a halo of r = n_taps
//     / 2 on its four sides (the corners are never read: the smoothing is a
//     sum of three 1-D passes). Per step the block computes dU of plane p
//     into the slot that plane p - n_taps - 1 has left, and finishes the
//     voxels of plane p - r - 1, whose 2r + 1 planes are complete: the x and
//     y taps from that plane's halo, the z taps from the ring, then the
//     step, psi', the live gather and the norm. One __syncthreads() per
//     plane: the spare slot lets the fill of one plane overlap the reads of
//     the one before.
//   - dU on the halo is recomputed by the block from psi and tnp (served by
//     L1/L2). Planes outside the segment (the z halo) fill the tile only,
//     planes inside it the cross: 256 + 80 r positions for 256 voxels. The
//     replicate edge is applied once, before the march: each thread clamps
//     its own voxel and its share of the halo into the grid and keeps their
//     offsets, so a position outside the grid holds dU of the clamped voxel
//     and the taps index without clamps.
//   - n_taps is a template parameter (the taps sit in registers, the tap
//     loops unroll); voxel arithmetic is 32-bit inside a channel, 64 bits
//     only for the scene and channel bases; any (Z, Y, X) is taken, tiles
//     over the grid's edge are masked.
//   - The march is csrc/gd_step.cuh's gd_march, which kernel E runs for
//     every iteration of its launch: psi', tnp', vel' and the norm equal
//     E's chained result bit for bit.
// Measured on an H100 80GB HBM3 at 700 W, device time per iteration at
// 128^3, 7 taps, K=2 (torch.profiler): the two launches this replaces 0.155
// ms (0.158 with momentum); this kernel 0.114 ms (0.122) with LZ = 16: 512
// blocks, four an SM, 64 registers, no spills, 51,072 bytes of shared
// memory a block. What was tried, in the order of the kernel's forms.
// First form (positions decoded and clamped per plane, every load indexed
// from the voxel index, 0.122-0.134 ms): LZ 8 / 16 / 32 gives 0.144 / 0.134
// / 0.180 and a tile of 4 or 16 rows 0.175 / 0.171 — fewer, longer segments
// recompute less of the z halo but leave SMs short of blocks. Capping a
// block's shared memory so that 3, 2, 1 blocks fit an SM instead of 4:
// 0.158 / 0.202 / 0.348 against 0.139 at LZ 8 — the march is a chain of
// dependent steps, and the blocks in flight hide its latency. A ring of
// n_taps slots with two barriers a plane (44,688 bytes, 5 blocks an SM): no
// gain (0.138 against 0.140). prefetch.global.L2 of the planes one to six
// steps ahead: 3% at LZ 16, 18% at LZ 32, never under the best without it.
// This form (the fill positions hoisted out of the march, loads addressed
// by pointer strides): 0.122 to 0.109. Asking for the voxel's psi and
// velocity before the fill instead of after the taps: 0.127 to 0.122 with
// momentum, 0.026 to 0.024 at 64^3. The SASS (cuobjdump) has ~200
// instructions per dU position (29 loads, 49 float operations, the rest
// address arithmetic) times 2.3 positions a voxel, and ~460 per finished
// voxel. cp.async / TMA staging of psi and tnp was not tried: it would add
// ~40 KB of shared memory a block and halve the blocks in flight.
//
// The stop test on the card (sobfu_gd_iterations): one call enqueues n
// launches on a ping-pong pair of state buffers. Row k of ctl holds, per
// scene, the iterations done before launch k (c >= 0: running; -(c + 1):
// frozen). Launch k runs scene s iff it is running and, for k > 0, launch
// k - 1's max norm passes the predicate sqrt(max_sq) > thresh — evaluated
// with __fsqrt_rn, the correctly rounded f32 root torch.sqrt and numpy
// return, so it is the host's test bit for bit; every block evaluates it
// from the same two words, and block 0 of the scene writes row k + 1. A
// frozen scene's blocks leave at once and write nothing (in the one-call
// form of kernels.gd_iteration_scenes they copy the scene's state through
// instead, as a false while_loop predicate does under jax.vmap). Iteration
// c reads buffer c & 1 and writes the other, so a scene's result lies in
// buffer (iterations done) & 1 whenever it stopped. Each launch has its own
// max norm row (zeroed once per call), as kernel E has. The host reads ctl
// row n, the norm rows and the energy once per call.
//
// The energy is not reduced by the fused kernel: a 3-D tile visits voxels
// in another order than kernel E's tiles of 256 consecutive voxels, whose
// fixed-order sum E's energy rows are held to bit for bit. Where the energy
// is asked for (the last launch of a call that ends on a stall check), a
// second pass reads tg and tnp' back and forms E's tile partials
// (energy_partials_kernel, then energy_final_kernel): two small launches on
// one iteration in stall_window, no float atomics, the same bits on every
// run.
//
// Scenes: one entry point takes S >= 1 scenes as grid dimension y. Scene s
// reads and writes its slice of every volume (base offsets s*N and s*3N),
// so scene s of a batch equals a one-scene launch on it bit for bit. One
// scene runs the kScenes = false instantiation, the scene index a constant.
//
// The slab form (sobfu_gd_slab_iterations, the kSlab instantiation) replaces
// the z_base / z_global contract of fused_gd_iteration_db_padded (:1075,
// body :848-850) and fused_gd_iteration_fold_padded (:1704), the per-shard
// kernel of the z-sharded solve (sobfu_tpu/parallel/sharding.py:216, :249).
// JAX launches it once per shard and iteration; here one launch covers a
// card group, the run of consecutive z-slabs that lie on one card: its rows
// in one buffer with H = 4 halo rows on either side, so a slab's
// neighbours' rows inside the group are read in place and only the rows at
// the group's ends are copied from other cards between iterations. Each dU
// position's row is clamped into the volume in global z (p + z_base against
// z_global) and read at that row's place in the group's buffer; the
// boundary masks, the voxel's coordinate and the live gather's clamp are
// global too, and the gather's global row is moved into live's rows as an
// integer (live is the group and its halo, or the whole volume for the
// exact warp). So each voxel computes what the whole-volume launch computes
// for it, bit for bit. A call enqueues n launches, the stop test on the
// card as sobfu_gd_iterations does it; launch k tests the max over the
// norm words of every group of the volume (the sharded solve's pmax) and
// writes its own group's. On one card the whole z axis is one group: a
// chunk of 16 iterations is one call and one host read, the plan A's (LZ =
// 16, 512 blocks at 128^3). On several cards each card's group runs one
// launch an iteration and the host copies the halo rows and the norm words
// between cards. The energy stays per slab (the tile partials over each
// slab's own rows, blockIdx.z the slab; one fixed-order sum per slab), so
// the host's sum over the slabs has the bits of one launch per slab.
// Bound: bytes, as A's (the group's state, tg and live with the rows the
// stencils reach in, its own rows out). The first form launched once per
// slab and iteration, its halo rows copied between slabs: a 32-row slab of
// 128^3 / 4 marched 4-plane segments (3.44 dU positions a voxel against
// 2.31 at LZ 16), 16 host enqueues an iteration. Measured on an H100 80GB
// HBM3 at 700 W (tools/bench_torch_kernels.py, the two forms in turns), an
// iteration at 128^3 in 4 slabs of one card, K=2, momentum 0.95: 0.2029 -
// 0.2096 -> 0.1253 - 0.1254 device ms and 0.38 - 0.61 -> 0.140 - 0.141 ms
// of wall, against 0.1251 - 0.1257 device ms for the whole-volume A
// through its loop: the group launch costs what A's costs, 32% of its
// bound with momentum; what is left is the march (A's header above). The
// gain needs several slabs on one card. make_mesh's default layout puts
// one slab on each card: there every group is one slab, and an iteration
// is the first form's launch and copies.
#include "gd_step.cuh"

namespace sobfu {

struct GdArgs {
  float* psi[2];  // the ping-pong pair: iteration c reads [c & 1]
  float* tnp[2];
  float* vel[2];  // both null without momentum
  const float* tg;
  const float* live;
  const float* taps;
  const int* ctl_in;             // [S] row k
  int* ctl_out;                  // [S] row k + 1
  const unsigned int* prev_max;  // [S] launch k - 1's max bits; null for k = 0
  unsigned int* max_bits;        // [S] this launch's
  float thresh;
  MarchShape m;
  int copy_frozen;  // a frozen scene's blocks copy its state to the other buffer
  // the slab form: prev_max holds [n_groups][S] words, the max bits of every
  // card group of the volume; live holds live_Z rows per scene
  int n_groups, live_Z;
};

// Whether scene s runs this launch and the iterations it has done; block 0
// of the scene writes the next row. kSlab: the norm tested is the max over
// the n_groups card groups of the volume (the sharded solve's pmax).
template <bool kSlab>
__device__ __forceinline__ bool gd_scene_on(const GdArgs& a, int s, int* count) {
  const int v = a.ctl_in[s];
  const bool frozen = v < 0;
  const int c = frozen ? -v - 1 : v;
  bool on = !frozen;
  if (on && a.prev_max != nullptr) {
    float mx = __uint_as_float(a.prev_max[s]);
    if (kSlab)
      for (int j = 1; j < a.n_groups; ++j)
        mx = nan_max(__uint_as_float(a.prev_max[j * gridDim.y + s]), mx);
    on = __fsqrt_rn(mx) > a.thresh;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl_out[s] = on ? c + 1 : -c - 1;
  *count = c;
  return on;
}

// kSlab: the slab form (gd_march's kSlab). psi, tnp, vel and tg are the
// card group's rows with m.H halo rows on either side (S scenes of m.Z + 2
// m.H rows), live S scenes of live_Z rows.
template <int NT, bool kScenes, bool kSlab>
__global__ void __launch_bounds__(kBlock, 4) gd_fused_kernel(const GdArgs a) {
  extern __shared__ float ring[];  // [3][NT + 1][kTileY + 2r][kTileX + 2r]

  const int s = kScenes ? (int)blockIdx.y : 0;
  int count;
  const bool on = gd_scene_on<kSlab>(a, s, &count);  // uniform over the block
  if (!on && !a.copy_frozen) return;

  const MarchShape& m = a.m;
  const unsigned N =
      kSlab ? (unsigned)(m.Z + 2 * m.H) * m.Y * m.X : (unsigned)m.Z * m.Y * m.X;
  const size_t fo = (size_t)3 * N * s, vo = (size_t)N * s;  // field and volume offsets
  const size_t ho = kSlab ? (size_t)m.H * m.Y * m.X : 0;     // the slab's row 0
  const size_t lo = kSlab ? (size_t)a.live_Z * m.Y * m.X * s : vo;
  const int par = count & 1;
  MarchIO io;
  io.psi = a.psi[par] + fo + ho;
  io.tnp = a.tnp[par] + vo + ho;
  io.vel = a.vel[par] != nullptr ? a.vel[par] + fo + ho : nullptr;
  io.tg = a.tg + vo + ho;
  io.live = a.live + lo;
  io.psi_out = a.psi[par ^ 1] + fo + ho;
  io.tnp_out = a.tnp[par ^ 1] + vo + ho;
  io.vel_out = io.vel != nullptr ? a.vel[par ^ 1] + fo + ho : nullptr;

  const Segment g = segment(blockIdx.x, m);
  if (!on) {  // the one-call form: the block's voxels pass through
    const int ly = threadIdx.x >> 5, lx = threadIdx.x & 31;
    if (g.gy0 + ly >= m.Y || g.gx0 + lx >= m.X) return;
    for (unsigned i = (g.z0 * m.Y + g.gy0 + ly) * m.X + g.gx0 + lx;
         i < (unsigned)(g.z1 * m.Y * m.X); i += m.Y * m.X) {
      for (int c = 0; c < 3; ++c) io.psi_out[(size_t)c * N + i] = io.psi[(size_t)c * N + i];
      if (io.vel != nullptr)
        for (int c = 0; c < 3; ++c) io.vel_out[(size_t)c * N + i] = io.vel[(size_t)c * N + i];
      io.tnp_out[i] = io.tnp[i];
    }
    return;
  }

  float w[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) w[u] = __ldg(a.taps + u);
  block_max_atomic(gd_march<NT, true, 0, 0, kSlab>(io, w, ring, g, m), a.max_bits + s);
}

// The tile partials of 0.5 * sum (tg - tnp')^2 after the call's last launch:
// sum over tile blockIdx.x of 256 consecutive voxels in block_sum's order —
// the partial kernel E forms for the same tile (gd_multi.cu). ctl is row n:
// a scene that ran the last launch has c >= 0 and its tnp' in buffer c & 1;
// a frozen scene's partials are 0. A scene's N voxels start stride floats
// after the previous scene's; the slab form: blockIdx.z is a slab of the
// card group, whose N voxels start slab_stride floats after the previous
// slab's (the pointers at the group's first own row). Partials [z][S][x].
template <bool kScenes>
__global__ void __launch_bounds__(kBlock)
    energy_partials_kernel(const float* tnp0, const float* tnp1, const float* __restrict__ tg,
                           const int* __restrict__ ctl, float* __restrict__ e_partials,
                           unsigned N, size_t stride, size_t slab_stride) {
  const int s = kScenes ? (int)blockIdx.y : 0;
  const int c = ctl[s];
  const unsigned i = blockIdx.x * kBlock + threadIdx.x;
  float e2 = 0.0f;
  if (c >= 0 && i < N) {
    const size_t o = stride * s + slab_stride * blockIdx.z;
    const float* tnp = ((c & 1) != 0 ? tnp1 : tnp0) + o;
    const float d = tg[o + i] - tnp[i];
    e2 = d * d;
  }
  const float sum = block_sum(e2);
  if (threadIdx.x == 0)
    e_partials[((size_t)blockIdx.z * gridDim.y + s) * gridDim.x + blockIdx.x] = sum;
}

// 0.5 * the sum of n tile partials, by one block in a fixed order; block b
// sums partials [b n, (b + 1) n) into out[b]: b = slab * S + s, scene s of
// the group's slab `slab` (the slab 0 but for the slab form).
__global__ void energy_final_kernel(const float* __restrict__ partials, long long n,
                                    float* __restrict__ out) {
  const float s = sum_partials(partials + blockIdx.x * n, n);
  if (threadIdx.x == 0) out[blockIdx.x] = 0.5f * s;
}

// A call of n launches. max_sq holds a row of n_groups * S words per launch
// (n_groups = 1 but for the slab form); launch k ORs its max bits into word
// `group` of row k, and tests the row before it (for k = 0, prev: the row
// of the previous call's last launch, or null).
struct GdCall {
  GdArgs a;
  int* ctl;
  float* max_sq;
  const unsigned int* prev;
  float* e_partials;
  float* e_data;
  int n, S, group;
  int n_slabs;  // the energy is per slab: n_slabs of the group's m.Z rows
  cudaStream_t stream;
};

// The dU ring's bytes: NT + 1 slots of three channels of the tile and its halo.
template <int NT>
constexpr size_t gd_smem_bytes() {
  return sizeof(float) * 3 * (NT + 1) * (kTileY + 2 * (NT / 2)) * (kTileX + 2 * (NT / 2));
}

// The tile partials and the fixed-order sum of the energy after a call's last
// launch, whose ctl row is ctl_n (energy_partials_kernel, energy_final_kernel),
// for S scenes of n_slabs slabs of N voxels: e_data[slab][S].
template <bool kScenes>
int gd_energy(const float* tnp0, const float* tnp1, const float* tg, const int* ctl_n,
              float* e_partials, float* e_data, unsigned N, size_t stride, int n_slabs, int S,
              cudaStream_t stream) {
  const int n_tiles = blocks_for(N);
  energy_partials_kernel<kScenes><<<dim3(n_tiles, S, n_slabs), kBlock, 0, stream>>>(
      tnp0, tnp1, tg, ctl_n, e_partials, N, stride, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  energy_final_kernel<<<S * n_slabs, kBlock, 0, stream>>>(e_partials, n_tiles, e_data);
  return (int)cudaGetLastError();
}

template <int NT, bool kScenes, bool kSlab>
int gd_launches(GdCall c) {
  GdArgs& a = c.a;
  constexpr size_t smem = gd_smem_bytes<NT>();
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gd_fused_kernel<NT, kScenes, kSlab>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t row = (size_t)a.n_groups * c.S;  // words a launch's norm row
  unsigned int* rows = reinterpret_cast<unsigned int*>(c.max_sq);
  unsigned int* mine = rows + (size_t)c.group * c.S;
  // zero this call's words of each row; another group's are left alone
  err = a.n_groups == 1
            ? cudaMemsetAsync(mine, 0, sizeof(float) * c.n * c.S, c.stream)
            : cudaMemset2DAsync(mine, sizeof(float) * row, 0, sizeof(float) * c.S, c.n, c.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.m.tiles_x * a.m.tiles_y * a.m.segs, c.S);
  for (int k = 0; k < c.n; ++k) {
    a.ctl_in = c.ctl + (size_t)k * c.S;
    a.ctl_out = c.ctl + (size_t)(k + 1) * c.S;
    a.prev_max = k > 0 ? rows + (size_t)(k - 1) * row : c.prev;
    a.max_bits = mine + (size_t)k * row;
    gd_fused_kernel<NT, kScenes, kSlab><<<grid, kBlock, smem, c.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (c.e_partials == nullptr) return 0;
  // each slab's own rows: the slab form's buffers start m.H rows before them
  const size_t XY = (size_t)a.m.Y * a.m.X, ho = kSlab ? a.m.H * XY : 0;
  const size_t stride = (size_t)(kSlab ? a.m.Z + 2 * a.m.H : a.m.Z) * XY;
  return gd_energy<kScenes>(a.tnp[0] + ho, a.tnp[1] + ho, a.tg + ho, c.ctl + (size_t)c.n * c.S,
                            c.e_partials, c.e_data, (unsigned)(a.m.Z / c.n_slabs * XY), stride,
                            c.n_slabs, c.S, c.stream);
}

template <int NT, bool kSlab>
int gd_launches_scenes(const GdCall& c) {
  return c.S == 1 ? gd_launches<NT, false, kSlab>(c) : gd_launches<NT, true, kSlab>(c);
}

}  // namespace sobfu

// n iterations of kernel A on S scenes, the stop test on the card.
// psi0/psi1, vel0/vel1 f32[S,3,Z,Y,X] and tnp0/tnp1 f32[S,Z,Y,X] are the
// ping-pong pair (vel0 and vel1 both null without momentum); tg, live
// f32[S,Z,Y,X]; taps f32[n_taps], n_taps odd <= 11. ctl i32[n+1,S]: the
// caller sets row 0 (per scene c >= 0: c iterations done, its state in
// buffer c & 1, running; -(c + 1): frozen), rows 1..n are written here.
// max_sq f32[n,S]: the max squared update norm of each launch, 0 where the
// scene did not run. e_partials f32[S, ceil(Z*Y*X / 256)] and e_data f32[S],
// or both null: the data energy after launch n - 1 of the scenes that ran
// it, 0 for the others. LZ is the z segment of a block, whose (y, x) tile is
// 8 x 32 (kernels.gd_tile_plan). copy_frozen != 0 (with n = 1): a frozen
// scene's state is copied to the other buffer, so that buffer holds every
// scene's state after the call. K < 0 = exact warp. 1 <= S <= 65535,
// Z*Y*X < 2^31.
extern "C" int sobfu_gd_iterations(float* psi0, float* psi1, float* tnp0, float* tnp1,
                                   float* vel0, float* vel1, const float* tg,
                                   const float* live, const float* taps, int n_taps,
                                   float alpha, float w_reg, float momentum, float thresh,
                                   int* ctl, float* max_sq, float* e_partials, float* e_data,
                                   int n, int S, int Z, int Y, int X, int K, int LZ,
                                   int copy_frozen, void* stream) {
  using namespace sobfu;
  const long long N = (long long)Z * Y * X;
  if (n < 1 || S < 1 || S > 65535 || N < 1 || N >= (1ll << 31) || LZ < 1)
    return (int)cudaErrorInvalidValue;
  GdCall c;
  GdArgs& a = c.a;
  a.psi[0] = psi0, a.psi[1] = psi1;
  a.tnp[0] = tnp0, a.tnp[1] = tnp1;
  a.vel[0] = vel0, a.vel[1] = vel1;
  a.tg = tg, a.live = live, a.taps = taps;
  a.thresh = thresh;
  a.m = march_shape(Z, Y, X, K, LZ, alpha, w_reg, momentum);
  a.copy_frozen = copy_frozen;
  a.n_groups = 1, a.live_Z = Z;
  c.ctl = ctl, c.max_sq = max_sq, c.prev = nullptr;
  c.e_partials = e_partials, c.e_data = e_data;
  c.n = n, c.S = S, c.group = 0, c.n_slabs = 1;
  c.stream = (cudaStream_t)stream;
  switch (n_taps) {
    case 1: return gd_launches_scenes<1, false>(c);
    case 3: return gd_launches_scenes<3, false>(c);
    case 5: return gd_launches_scenes<5, false>(c);
    case 7: return gd_launches_scenes<7, false>(c);
    case 9: return gd_launches_scenes<9, false>(c);
    case 11: return gd_launches_scenes<11, false>(c);
  }
  return (int)cudaErrorInvalidValue;
}

// n iterations of kernel A's slab form (the z_base / z_global contract of
// fused_gd_iteration_db_padded and fused_gd_iteration_fold_padded) on the S
// scenes of card group `group` of n_groups: rows [z_base, z_base + Zg) of a
// z_global-deep volume, n_slabs z-slabs of Zg / n_slabs rows. psi0/psi1,
// vel0/vel1 f32[S,3,Zg+2H,Y,X], tnp0/tnp1 and tg f32[S,Zg+2H,Y,X]: the
// group's rows with H halo rows on either side, which hold the neighbouring
// groups' rows (the caller copies them between iterations; the rows past
// the volume's ends are never read). live f32[S,live_Z,Y,X], its row 0 at
// global row live_z0 (its rows past the volume's ends are never read): the
// whole volume (live_z0 = 0, live_Z = z_global; the exact warp needs it) or
// the group and at least K rows on either side. ctl i32[n+1,S] and the
// buffer parity as in sobfu_gd_iterations. max_rows: n rows of
// [n_groups][S] words, a row every n_groups * S; launch k zeroes and ORs
// its max bits into word `group` of row k and tests the max over the whole
// row before it — for k = 0 over max_prev ([n_groups][S], the previous
// call's last row), or no test if it is null. e_partials f32[n_slabs, S,
// ceil(Zg/n_slabs*Y*X / 256)] and e_data f32[n_slabs, S], or both null: the
// energy of each slab's rows after launch n - 1, 0 for a scene that did not
// run it. Each voxel's psi', tnp', vel' and update norm equal the
// whole-volume launch's on the same volume bit for bit. n_taps odd <= 2H -
// 1, 1 <= S <= 65535, (Zg + 2H)*Y*X and live_Z*Y*X under 2^31.
extern "C" int sobfu_gd_slab_iterations(float* psi0, float* psi1, float* tnp0, float* tnp1,
                                        float* vel0, float* vel1, const float* tg,
                                        const float* live, const float* taps, int n_taps,
                                        float alpha, float w_reg, float momentum, float thresh,
                                        int* ctl, const float* max_prev, float* max_rows,
                                        int group, int n_groups, float* e_partials,
                                        float* e_data, int n_slabs, int n, int S, int Zg, int Y,
                                        int X, int H, int z_base, int z_global, int live_z0,
                                        int live_Z, int K, int LZ, int copy_frozen,
                                        void* stream) {
  using namespace sobfu;
  const long long XY = (long long)Y * X;
  if (n < 1 || S < 1 || S > 65535 || Zg < 1 || XY < 1 || LZ < 1 || n_groups < 1 ||
      group < 0 || group >= n_groups || n_slabs < 1 || Zg % n_slabs != 0 || z_base < 0 ||
      z_base + Zg > z_global || n_taps < 1 || n_taps % 2 == 0 || H < n_taps / 2 + 1 ||
      (Zg + 2ll * H) * XY >= (1ll << 31) || (long long)live_Z * XY >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // the global rows the live gather reaches: all of them for the exact warp,
  // the group's and K on either side (clamped into the volume) for the window
  const int need_lo = K < 0 || z_base < K ? 0 : z_base - K;
  const int need_hi = K < 0 || z_base + Zg + K > z_global ? z_global : z_base + Zg + K;
  if (live_z0 > need_lo || live_z0 + live_Z < need_hi)
    return (int)cudaErrorInvalidValue;
  GdCall c;
  GdArgs& a = c.a;
  a.psi[0] = psi0, a.psi[1] = psi1;
  a.tnp[0] = tnp0, a.tnp[1] = tnp1;
  a.vel[0] = vel0, a.vel[1] = vel1;
  a.tg = tg, a.live = live, a.taps = taps;
  a.thresh = thresh;
  a.m = march_shape(Zg, Y, X, K, LZ, alpha, w_reg, momentum);
  a.m.H = H, a.m.z_base = z_base, a.m.z_global = z_global, a.m.live_z0 = live_z0;
  a.copy_frozen = copy_frozen;
  a.n_groups = n_groups, a.live_Z = live_Z;
  c.ctl = ctl, c.max_sq = max_rows, c.prev = reinterpret_cast<const unsigned int*>(max_prev);
  c.e_partials = e_partials, c.e_data = e_data;
  c.n = n, c.S = S, c.group = group, c.n_slabs = n_slabs;
  c.stream = (cudaStream_t)stream;
  switch (n_taps) {
    case 1: return gd_launches_scenes<1, true>(c);
    case 3: return gd_launches_scenes<3, true>(c);
    case 5: return gd_launches_scenes<5, true>(c);
    case 7: return gd_launches_scenes<7, true>(c);
  }
  return (int)cudaErrorInvalidValue;
}
