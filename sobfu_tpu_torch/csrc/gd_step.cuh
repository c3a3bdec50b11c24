// The arithmetic of one Sobolev gradient-descent iteration, written once over
// value getters, and the two global-memory bodies built from it.
//
// The arithmetic (gd_potential, sobolev_sum, gd_step_channel, norm_sq) takes
// its operands through getters, so the same instructions in the same order
// serve every kernel whatever memory the operands come from:
//   - kernel A (csrc/gd_iteration.cu) computes dU into shared memory and
//     convolves it from there, one launch per iteration;
//   - kernel E (csrc/gd_multi.cu, n iterations in one cooperative launch)
//     runs the two global-memory bodies below (gd_potential_voxel writes dU
//     to a scratch field, gd_update_tile gathers it back) between grid syncs.
// Built with --fmad=false, both therefore land on the same bits: E equals
// chained A launches bit for bit.
//
// The bodies cut the work into tiles of kBlock consecutive voxels, thread t
// of a block taking voxel tile * kBlock + t; E walks the tiles with a
// grid-stride loop. Every per-iteration reduction is formed per tile in a
// fixed order (sampling.cuh block_sum / block_max_atomic) and the tile
// partials are summed by one block in a fixed order (sum_partials), so the
// result does not depend on how tiles map to blocks. A's energy pass
// (gd_iteration.cu energy_partials_kernel) forms the same tile partials.
//
// Kernel E writes psi, tnp, vel and dU between grid syncs, so only the
// loop-invariant live volume and taps are read through the read-only path
// (__ldg) there; everything else is a plain load.
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

// gd_potential at voxel i < N from global memory, written to dU.
__device__ __forceinline__ void gd_potential_voxel(long long i, const float* psi,
                                                   const float* tnp, const float* tg,
                                                   float w_reg, float* dU, int Z, int Y,
                                                   int X) {
  const long long N = (long long)Z * Y * X;
  const int x = (int)(i % X);
  const int y = (int)((i / X) % Y);
  const int z = (int)(i / ((long long)X * Y));
  const long long sy = X, sz = (long long)X * Y;
  float d[3];
  gd_potential(
      x > 0 && x < X - 1, y > 0 && y < Y - 1, z > 0 && z < Z - 1, tg[i], w_reg,
      [&](int dx, int dy, int dz) { return tnp[i + dx + dy * sy + dz * sz]; },
      [&](int c, int dx, int dy, int dz) { return psi[c * N + i + dx + dy * sy + dz * sz]; },
      d);
  for (int c = 0; c < 3; ++c) dU[c * N + i] = d[c];
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

// The update of tile `tile`: the three axis convolutions of dU, the
// (momentum) step, psi' and tnp' = trilinear(live, psi'), and the tile's
// reductions: max ||update||^2 into *max_bits (atomicMax on the bits) and,
// when e_partials is set, sum (tg - tnp')^2 into e_partials[tile].
// Every thread of the block must call it.
__device__ __forceinline__ void gd_update_tile(
    long long tile, const float* psi, const float* vel, const float* live, const float* dU,
    const float* taps, int n_taps, float alpha, float momentum, float* psi_out,
    float* tnp_out, float* vel_out, const float* tg, unsigned int* max_bits,
    float* e_partials, int Z, int Y, int X, int K, float hi) {
  const long long N = (long long)Z * Y * X;
  const long long i = tile * kBlock + threadIdx.x;
  float n2 = 0.0f, e2 = 0.0f;
  if (i < N) {
    const int x = (int)(i % X);
    const int y = (int)((i / X) % Y);
    const int z = (int)(i / ((long long)X * Y));
    const int r = n_taps / 2;
    const long long row = i - x;                     // (z, y, 0)
    const long long col = (long long)z * Y * X + x;  // (z, 0, x)
    const long long pil = (long long)y * X + x;      // (0, y, x)
    float p_new[3], upd[3];
    for (int c = 0; c < 3; ++c) {
      const float* f = dU + c * N;
      const float dus = sobolev_sum(
          n_taps, [&](int u) { return __ldg(taps + u); },
          [&](int u) { return f[row + min(max(x + r - u, 0), X - 1)]; },
          [&](int u) { return f[col + (long long)min(max(y + r - u, 0), Y - 1) * X]; },
          [&](int u) { return f[pil + (long long)min(max(z + r - u, 0), Z - 1) * Y * X]; });
      float step;
      upd[c] = gd_step_channel(dus, vel != nullptr, vel != nullptr ? vel[c * N + i] : 0.0f,
                               psi[c * N + i], alpha, momentum, &step, &p_new[c]);
      if (vel != nullptr) vel_out[c * N + i] = step;
      psi_out[c * N + i] = p_new[c];
    }
    n2 = norm_sq(upd);
    const Taps3 t = taps3(p_new[0], p_new[1], p_new[2], x, y, z, Z, Y, X, K, hi);
    const float t_new = trilinear(t, K < 0, [&](int xi, int yi, int zi) {
      return __ldg(live + flat_index(xi, yi, zi, Y, X));
    });
    tnp_out[i] = t_new;
    if (e_partials != nullptr) {
      const float d = tg[i] - t_new;
      e2 = d * d;
    }
  }
  block_max_atomic(n2, max_bits);
  if (e_partials != nullptr) {
    const float s = block_sum(e2);
    if (threadIdx.x == 0) e_partials[tile] = s;
  }
}

}  // namespace sobfu
