// The arithmetic of one Sobolev gradient-descent iteration, written once over
// value getters, and the z-march that both iteration kernels run.
//
// The arithmetic (gd_potential, sobolev_sum, gd_step_channel, norm_sq) takes
// its operands through getters, so the same instructions in the same order
// serve every kernel whatever memory the operands come from. gd_march is
// one block's iteration over one z segment of one (y, x) tile: dU in a ring
// of shared-memory planes (csrc/gd_iteration.cu's header describes it).
//   - kernel A (csrc/gd_iteration.cu) runs it once per block and launch;
//   - kernel E (csrc/gd_multi.cu, n iterations in one cooperative launch)
//     runs it for each segment a block owns, once per iteration, with one
//     grid sync between iterations.
// Built with --fmad=false, both therefore land on the same bits: E equals
// chained A launches bit for bit.
//
// Every per-iteration reduction is formed per tile in a fixed order
// (sampling.cuh block_sum / block_max_atomic) and the tile partials are
// summed by one block in a fixed order (sum_partials); the energies' tiles
// are 256 consecutive voxels, whatever tiles the march uses.
#pragma once

#include "sampling.cuh"

namespace sobfu {

// dU[c] = (tnp - tg) * grad(tnp)[c] + w_reg * (-lap psi[c]) at one voxel.
//   grad: central difference, 0 on each axis's boundary slices (in_x false)
//   lap:  per-axis second difference, 0 on that axis's boundary slices
// tnp(dx, dy, dz) and psi(c, dx, dy, dz) return the value at the voxel's
// neighbour; they are called only where the neighbour is inside the grid.
template <typename TnpAt, typename PsiAt>
__device__ __forceinline__ void gd_potential(bool in_x, bool in_y, bool in_z, float tg_c,
                                             float w_reg, TnpAt tnp, PsiAt psi, float* dU) {
  const float gx = in_x ? (tnp(1, 0, 0) - tnp(-1, 0, 0)) * 0.5f : 0.0f;
  const float gy = in_y ? (tnp(0, 1, 0) - tnp(0, -1, 0)) * 0.5f : 0.0f;
  const float gz = in_z ? (tnp(0, 0, 1) - tnp(0, 0, -1)) * 0.5f : 0.0f;
  const float diff = tnp(0, 0, 0) - tg_c;
  const float grad[3] = {gx, gy, gz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float pc = psi(c, 0, 0, 0);
    const float sdx = in_x ? (psi(c, 1, 0, 0) + psi(c, -1, 0, 0)) - 2.0f * pc : 0.0f;
    const float sdy = in_y ? (psi(c, 0, 1, 0) + psi(c, 0, -1, 0)) - 2.0f * pc : 0.0f;
    const float sdz = in_z ? (psi(c, 0, 0, 1) + psi(c, 0, 0, -1)) - 2.0f * pc : 0.0f;
    const float lap = -((sdx + sdy) + sdz);
    dU[c] = diff * grad[c] + w_reg * lap;
  }
}

// conv_x + conv_y + conv_z of one channel at one voxel: fx(u), fy(u), fz(u)
// return dU at the voxel's coordinate + r - u along their axis (replicate
// edge), w(u) tap u. Taps accumulate u = 0 .. n_taps - 1 into three sums,
// added as (cx + cy) + cz.
template <typename W, typename FX, typename FY, typename FZ>
__device__ __forceinline__ float sobolev_sum(int n_taps, W w, FX fx, FY fy, FZ fz) {
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
#pragma unroll
  for (int u = 0; u < n_taps; ++u) {
    const float wu = w(u);
    cx = cx + wu * fx(u);
    cy = cy + wu * fy(u);
    cz = cz + wu * fz(u);
  }
  return (cx + cy) + cz;
}

// One channel's step from its smoothed gradient dus: *step = mu * vel + dus
// with momentum (the new velocity), dus without; *p_new = psi - alpha *
// step. Returns the update alpha * step.
__device__ __forceinline__ float gd_step_channel(float dus, bool has_vel, float vel_c,
                                                 float psi_c, float alpha, float momentum,
                                                 float* step, float* p_new) {
  *step = has_vel ? momentum * vel_c + dus : dus;
  const float upd = alpha * *step;
  *p_new = psi_c - upd;
  return upd;
}

__device__ __forceinline__ float norm_sq(const float* upd) {
  return (upd[0] * upd[0] + upd[1] * upd[1]) + upd[2] * upd[2];
}

// The summands of the verbose energies at voxel i < N, before the update:
// (tg - tnp)^2 and ||J||_F^2 with J the central-difference Jacobian of the
// displacement psi - identity (0 on boundary slices; fields.jacobian).
__device__ __forceinline__ void verbose_voxel(long long i, const float* psi, const float* tnp,
                                              const float* tg, int Z, int Y, int X,
                                              float* e_sq, float* j_sq) {
  const long long N = (long long)Z * Y * X;
  const int v[3] = {(int)(i % X), (int)((i / X) % Y), (int)(i / ((long long)X * Y))};
  const int n[3] = {X, Y, Z};
  const long long s[3] = {1, X, (long long)X * Y};
  const float d = tg[i] - tnp[i];
  *e_sq = d * d;
  float acc = 0.0f;
  for (int r = 0; r < 3; ++r) {
    const float* p = psi + r * N;
    for (int c = 0; c < 3; ++c) {
      if (v[c] == 0 || v[c] == n[c] - 1) continue;  // a zero of the Jacobian
      const float step = r == c ? 1.0f : 0.0f;
      const float hi = p[i + s[c]] - ((float)v[r] + step);
      const float lo = p[i - s[c]] - ((float)v[r] - step);
      const float jd = (hi - lo) * 0.5f;
      acc = acc + jd * jd;
    }
  }
  *j_sq = acc;
}

constexpr int kTileX = 32, kTileY = 8;  // kTileX * kTileY == kBlock: a voxel a thread per plane

// What a march reads and writes. vel and vel_out are null without momentum.
struct MarchIO {
  const float* psi;
  const float* tnp;
  const float* vel;
  const float* tg;
  const float* live;
  float* psi_out;
  float* tnp_out;
  float* vel_out;
};

// The grid, its tiling and the step's scalars.
struct MarchShape {
  int Z, Y, X, K;  // K < 0: exact warp
  int LZ, tiles_x, tiles_y, segs;
  float hi, alpha, w_reg, momentum;
  // The slab form (gd_march's kSlab): Z is the depth of one z-slab of a
  // z_global-deep volume whose global row z_base is the slab's row 0. The
  // state buffers carry H halo rows on either side of the slab (the
  // neighbours' rows, exchanged between iterations); live's row 0 is global
  // row live_z0. Unused by the whole-volume march.
  int H, z_base, z_global, live_z0;
};

inline MarchShape march_shape(int Z, int Y, int X, int K, int LZ, float alpha, float w_reg,
                              float momentum) {
  MarchShape m;
  m.Z = Z, m.Y = Y, m.X = X, m.K = K;
  m.LZ = LZ;
  m.tiles_x = (X + kTileX - 1) / kTileX;
  m.tiles_y = (Y + kTileY - 1) / kTileY;
  m.segs = (Z + LZ - 1) / LZ;
  m.hi = (float)((double)K - 1e-4);
  m.alpha = alpha, m.w_reg = w_reg, m.momentum = momentum;
  m.H = 0, m.z_base = 0, m.z_global = Z, m.live_z0 = 0;
  return m;
}

// The (y, x) tile and the z segment [z0, z1) of segment index b.
struct Segment {
  int gx0, gy0, z0, z1;
};

// kCube: the grid is kCube^3, known at compile time (0: m's extents).
template <int kCube = 0>
__device__ __forceinline__ Segment segment(int b, const MarchShape& m) {
  const int tiles_x = kCube ? (kCube + kTileX - 1) / kTileX : m.tiles_x;
  const int tiles_y = kCube ? (kCube + kTileY - 1) / kTileY : m.tiles_y;
  Segment g;
  g.gx0 = (b % tiles_x) * kTileX;
  b /= tiles_x;
  g.gy0 = (b % tiles_y) * kTileY;
  g.z0 = (b / tiles_y) * m.LZ;
  g.z1 = min(g.z0 + m.LZ, kCube ? kCube : m.Z);
  return g;
}

// kRO: psi, tnp and vel stay unwritten for the whole launch (kernel A), so
// they are read through the read-only path from restrict pointers; kernel E
// writes them between grid syncs and reads them with plain loads from plain
// pointers, which the compiler never turns into read-only loads.
template <bool kRO>
struct StatePtr {
  typedef const float* type;
};
template <>
struct StatePtr<true> {
  typedef const float* __restrict__ type;
};

template <bool kRO>
__device__ __forceinline__ float ld_state(const float* p) {
  if (kRO) return __ldg(p);
  return *p;
}

// One iteration of segment b by the whole block (every thread must call
// it): dU of the segment's planes into the ring (NT + 1 slots of three
// channels, each the tile plus a halo of r = NT / 2 on its four sides),
// then each finished plane's smoothing, step, psi', the live gather and
// tnp'. Returns the thread's max squared update norm. It ends on a
// __syncthreads(), so the ring may be refilled at once. kCube != 0: the grid
// is kCube^3 and every stride is a constant, so the fill's 29 loads a
// position are immediate offsets from two pointers. kLZ != 0: every
// segment has kLZ planes (the caller's LZ divides Z), so the march's
// kLZ + 2r + 1 plane steps unroll and each step's fill, cross halo and
// finish are known at compile time. kSlab: the march runs on one z-slab
// (MarchShape's slab fields; every pointer of io but live at the slab's row
// 0, a channel m.Z + 2 m.H rows long): each plane's replicate edge and
// boundary masks, the voxel's coordinate and the live gather's clamp are
// decided in global z, and the gather's global row is moved into live's
// rows as an integer, so every voxel computes what the whole-volume march
// computes for it.
template <int NT, bool kRO, int kCube = 0, int kLZ = 0, bool kSlab = false>
__device__ __forceinline__ float gd_march(const MarchIO& io, const float (&w)[NT], float* ring,
                                          const Segment g, const MarchShape& m) {
  constexpr int r = NT / 2;
  constexpr int kSlots = NT + 1;
  constexpr int HX = kTileX + 2 * r, HY = kTileY + 2 * r;
  constexpr int kPlane = HY * HX;       // floats of one channel of one slot
  constexpr int kChan = kSlots * kPlane;  // floats of one channel
  constexpr int kRows = 2 * r * kTileX;   // halo positions above and below the tile
  constexpr int kHalo = kRows + 2 * r * kTileY;  // ... and beside it
  constexpr int NH = (kHalo + kBlock - 1) / kBlock;  // a thread's share of the halo
  constexpr int kSide = r > 0 ? 2 * r : 1;

  const int Z = kCube ? kCube : m.Z, Y = kCube ? kCube : m.Y, X = kCube ? kCube : m.X;
  const int XY = X * Y;
  const unsigned N = (unsigned)(kSlab ? Z + 2 * m.H : Z) * XY;
  // global z: the slab's first row, the volume's depth, live's first row
  const int zb = kSlab ? m.z_base : 0, zG = kSlab ? m.z_global : Z, lz0 = kSlab ? m.live_z0 : 0;
  const ptrdiff_t sX = X, sXY = XY, sN = N;  // strides as pointer offsets
  typename StatePtr<kRO>::type psi = io.psi;
  typename StatePtr<kRO>::type tnp = io.tnp;
  typename StatePtr<kRO>::type vel = io.vel;
  const float* __restrict__ tg = io.tg;
  const float* __restrict__ live = io.live;
  float* __restrict__ psi_out = io.psi_out;
  float* __restrict__ tnp_out = io.tnp_out;
  float* __restrict__ vel_out = io.vel_out;
  const int gx0 = g.gx0, gy0 = g.gy0, z0 = g.z0, z1 = g.z1;

  // the thread's voxel of every plane, and whether the grid has it
  const int tid = threadIdx.x;
  const int ly = tid >> 5, lx = tid & 31;
  const bool mine = gy0 + ly < Y && gx0 + lx < X;
  const int vox = (gy0 + ly) * X + gx0 + lx;

  // The positions of a plane whose dU this thread computes: [0] its own
  // voxel, [1..NH] its share of the cross-shaped halo (filled on the
  // segment's own planes only). Each is clamped into the grid once, here:
  // off is y * X + x of the clamped voxel, dst its place in a slot.
  int off[1 + NH], dst[1 + NH];
  bool has[1 + NH], in_x[1 + NH], in_y[1 + NH];
#pragma unroll
  for (int k = 0; k <= NH; ++k) {
    int py = ly + r, px = lx + r;
    has[k] = true;
    if (k > 0) {
      const int h = tid + (k - 1) * kBlock;
      has[k] = h < kHalo;
      if (h < kRows) {  // rows 0 .. r-1 and kTileY+r .. kTileY+2r-1, the tile's columns
        const int j = h >> 5;
        py = j < r ? j : kTileY + j;
        px = r + (h & 31);
      } else {  // 2r columns beside each of the tile's rows
        const int e = h - kRows, col = e % kSide;
        py = r + e / kSide;
        px = col < r ? col : kTileX + col;
      }
    }
    const int yc = min(max(gy0 + py - r, 0), Y - 1);
    const int xc = min(max(gx0 + px - r, 0), X - 1);
    off[k] = yc * X + xc;
    dst[k] = py * HX + px;
    in_x[k] = xc > 0 && xc < X - 1;
    in_y[k] = yc > 0 && yc < Y - 1;
  }

  float n2_max = 0.0f;
  // kLZ != 0: every segment has kLZ planes (the launch's LZ divides the grid)
  const int nz = kLZ ? kLZ : z1 - z0;
#pragma unroll (kLZ ? kLZ + 2 * r + 1 : 1)
  for (int q = 0; q <= nz + 2 * r; ++q) {
    const int p = z0 - r + q;
    // the voxel finished this step: its planes zo - r .. zo + r were filled before
    const int zo = p - r - 1;
    const bool finish = q >= 2 * r + 1 && mine;
    const int i = zo * XY + vox;
    // its psi and velocity are asked for before the fill, whose loads hide theirs
    float psi_c[3], vel_c[3] = {0.0f, 0.0f, 0.0f};
    if (finish) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        psi_c[c] = ld_state<kRO>(psi + (c * sN + i));
        if (vel != nullptr) vel_c[c] = ld_state<kRO>(vel + (c * sN + i));
      }
    }
    if (q < nz + 2 * r) {
      // dU of plane p (clamped into the grid) into its slot
      float* slot = ring + (q % kSlots) * kPlane;
      const bool cross = q >= r && q < r + nz;  // an output plane: the x and y halos too
      const int zg = min(max(p + zb, 0), zG - 1);
      const int zc = zg - zb;
      const bool in_z = zg > 0 && zg < zG - 1;
#pragma unroll
      for (int k = 0; k <= NH; ++k) {
        if (k > 0 && !(cross && has[k])) continue;
        const int i = zc * XY + off[k];
        const float* pt = tnp + i;
        const float* pp = psi + i;
        float d[3];
        gd_potential(
            in_x[k], in_y[k], in_z, __ldg(tg + i), m.w_reg,
            [&](int dx, int dy, int dz) { return ld_state<kRO>(pt + (dx + dy * sX + dz * sXY)); },
            [&](int c, int dx, int dy, int dz) {
              return ld_state<kRO>(pp + (c * sN + dx + dy * sX + dz * sXY));
            },
            d);
        float* q = slot + dst[k];
        q[0] = d[0];
        q[kChan] = d[1];
        q[2 * kChan] = d[2];
      }
    }
    if (finish) {
      const int sb = (q - 1) % kSlots;  // slot of plane zo + r; plane zo + r - u: sb - u
      const float* f0 = ring + ((q - r - 1) % kSlots) * kPlane + dst[0];  // plane zo, channel 0
      const float* fz = ring + dst[0];                                       // slot 0, channel 0
      float p_new[3], upd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dus = sobolev_sum(
            NT, [&](int u) { return w[u]; }, [&](int u) { return f0[c * kChan + (r - u)]; },
            [&](int u) { return f0[c * kChan + (r - u) * HX]; },
            [&](int u) {
              const int su = sb - u;
              return fz[c * kChan + (su < 0 ? su + kSlots : su) * kPlane];
            });
        const ptrdiff_t ci = c * sN + i;
        float step;
        upd[c] = gd_step_channel(dus, vel != nullptr, vel_c[c], psi_c[c], m.alpha, m.momentum,
                                 &step, &p_new[c]);
        if (vel != nullptr) vel_out[ci] = step;
        psi_out[ci] = p_new[c];
      }
      n2_max = nan_max(norm_sq(upd), n2_max);
      const Taps3 t = taps3(p_new[0], p_new[1], p_new[2], gx0 + lx, gy0 + ly, zo + zb, zG, Y, X,
                            m.K, m.hi);
      tnp_out[i] = trilinear(t, m.K < 0, [&](int xi, int yi, int zi) {
        return __ldg(live + ((zi - lz0) * XY + yi * X + xi));
      });
    }
    __syncthreads();
  }
  return n2_max;
}

}  // namespace sobfu
