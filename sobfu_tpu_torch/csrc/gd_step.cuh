// The two bodies of one Sobolev gradient-descent iteration, shared by kernel
// A (csrc/gd_iteration.cu, one launch per body) and kernel E
// (csrc/gd_multi.cu, n iterations in one cooperative launch), so that both
// run the same instructions and E equals chained A launches bit for bit.
//
// Work is cut into tiles of kBlock consecutive voxels, thread t of a block
// taking voxel tile * kBlock + t. A runs one tile per block; E walks the
// tiles with a grid-stride loop. Every per-iteration reduction is formed per
// tile in a fixed order (sampling.cuh block_sum / block_max_atomic) and the
// tile partials are summed by one block in a fixed order (sum_partials), so
// the result does not depend on how tiles map to blocks.
//
// Kernel E writes psi, tnp, vel and dU between grid syncs, so only the
// loop-invariant live volume and taps are read through the read-only path
// (__ldg); everything else is a plain load.
#pragma once

#include "sampling.cuh"

namespace sobfu {

// dU = (tnp - tg) * grad(tnp) + w_reg * (-lap psi) at voxel i < N.
//   grad: central difference, 0 on each axis's boundary slices
//   lap:  per-axis second difference, 0 on that axis's boundary slices
__device__ __forceinline__ void gd_potential_voxel(long long i, const float* psi,
                                                   const float* tnp, const float* tg,
                                                   float w_reg, float* dU, int Z, int Y,
                                                   int X) {
  const long long N = (long long)Z * Y * X;
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
      float cx = 0.0f, cy = 0.0f, cz = 0.0f;
      for (int u = 0; u < n_taps; ++u) {
        const float w = __ldg(taps + u);
        const int xs = min(max(x + r - u, 0), X - 1);
        const int ys = min(max(y + r - u, 0), Y - 1);
        const int zs = min(max(z + r - u, 0), Z - 1);
        cx = cx + w * f[row + xs];
        cy = cy + w * f[col + (long long)ys * X];
        cz = cz + w * f[pil + (long long)zs * Y * X];
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
