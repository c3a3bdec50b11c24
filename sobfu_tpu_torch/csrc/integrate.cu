// Kernel I: projective TSDF integration of a dists map (the live volume of
// a frame) in one pass.
//
// Computes what sobfu_tpu_torch/ops/frontend.py integrate_dists_plain
// computes (reference tsdf_volume.cu:62-101; in the JAX package
// sobfu_tpu/tsdf.py integrate_dists, XLA, no TPU kernel): per voxel,
// project the centre, read dists at the floor pixel, psdf = Dp - z_cam;
// weight = psdf > -eta, value = clamp(psdf / trunc, -1, 1). Voxels outside
// the image, with Dp <= 0 or z_cam <= 0 keep their (tsdf, weight). The
// plain version is about 54 launches over the grid; here one thread takes
// one voxel, x fastest.
//
// Bits. The axis-aligned branch (the caller certifies vol2cam[:3,:3] = I)
// follows the plain version's arithmetic: xs, ys, zs and u, v as
// torch.addcmul computes them on the card (one rounding: __fmaf_rn; its
// other operations stay separately rounded, --fmad=false), inv_z = 1 / zs,
// the floor pixel. The general branch rotates the centre in a fixed order,
// each row of vol2cam an FMA chain, then adds t; cuBLAS sums the plain
// version's einsum in an order of its own, so this branch agrees to an ulp
// of the camera depth. u = fx * (x / z) + cx. The voxel centre is
// (i + 0.5) * vs, the slab's z_offset * vs added to z.
//
// Bound on the H100: the bytes (tsdf and weight in and out, 16 B a voxel,
// and the dists map).
#include <cuda_runtime.h>

#include "sampling.cuh"

namespace sobfu {

struct IntegrateArgs {
  int Z, Y, X, H, W, z_offset, axis_aligned;
  float r[9], t[3];
  float fx, fy, cx, cy;
  float vsx, vsy, vsz;
  float trunc, eta;
};

// torch.addcmul(a, b, c) on the card: a + b * c rounded once
__device__ __forceinline__ float addcmul(float a, float b, float c) {
  return __fmaf_rn(b, c, a);
}

__global__ void integrate_live_kernel(const float* __restrict__ tsdf,
                                      const float* __restrict__ weight,
                                      const float* __restrict__ dists, float* __restrict__ tout,
                                      float* __restrict__ wout, IntegrateArgs a) {
  const long long N = (long long)a.Z * a.Y * a.X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int x = (int)(i % a.X);
  const int y = (int)((i / a.X) % a.Y);
  const int z = (int)(i / ((long long)a.X * a.Y));
  float t_new = tsdf[i], w_new = weight[i];
  bool in_image;
  float u, v, cam_z;
  if (a.axis_aligned) {
    const float xs = addcmul(a.t[0], (float)x + 0.5f, a.vsx);
    const float ys = addcmul(a.t[1], (float)y + 0.5f, a.vsy);
    const float zs = addcmul(a.t[2], ((float)z + 0.5f) + (float)a.z_offset, a.vsz);
    const float inv_z = 1.0f / zs;
    u = addcmul(a.cx, a.fx * xs, inv_z);
    v = addcmul(a.cy, a.fy * ys, inv_z);
    in_image = (u >= 0.0f) && (u < (float)a.W) && (v >= 0.0f) && (v < (float)a.H);
    cam_z = zs;
  } else {
    const float vx = ((float)x + 0.5f) * a.vsx;
    const float vy = ((float)y + 0.5f) * a.vsy;
    const float vz = ((float)z + 0.5f) * a.vsz + (float)a.z_offset * a.vsz;
    float cam[3];
    for (int c = 0; c < 3; ++c) {
      const float* m = a.r + 3 * c;
      cam[c] = __fmaf_rn(m[2], vz, __fmaf_rn(m[1], vy, m[0] * vx)) + a.t[c];
    }
    u = a.fx * (cam[0] / cam[2]) + a.cx;
    v = a.fy * (cam[1] / cam[2]) + a.cy;
    in_image = (u >= 0.0f) && (v >= 0.0f) && (u < (float)a.W) && (v < (float)a.H);
    cam_z = cam[2];
  }
  if (in_image) {
    const int ui = min(max((int)floorf(u), 0), a.W - 1);
    const int vi = min(max((int)floorf(v), 0), a.H - 1);
    const float Dp = __ldg(dists + (long long)vi * a.W + ui);
    if (Dp > 0.0f && cam_z > 0.0f) {
      const float psdf = Dp - cam_z;
      w_new = psdf > -a.eta ? 1.0f : 0.0f;
      t_new = clampf(psdf / a.trunc, -1.0f, 1.0f);
    }
  }
  tout[i] = t_new;
  wout[i] = w_new;
}

}  // namespace sobfu

// tsdf, weight, tout, wout f32[Z, Y, X] (the outputs may not alias the
// inputs); dists f32[H, W]. p holds 21 floats: vol2cam's rotation row-major
// (9), its translation (3), fx, fy, cx, cy, the voxel sizes (x, y, z), trunc
// and eta.
extern "C" int sobfu_integrate_dists(const float* tsdf, const float* weight, const float* dists,
                                     float* tout, float* wout, int Z, int Y, int X, int H, int W,
                                     int z_offset, int axis_aligned, const float* p,
                                     void* stream) {
  sobfu::IntegrateArgs a;
  a.Z = Z, a.Y = Y, a.X = X, a.H = H, a.W = W, a.z_offset = z_offset;
  a.axis_aligned = axis_aligned;
  for (int j = 0; j < 9; ++j) a.r[j] = p[j];
  for (int j = 0; j < 3; ++j) a.t[j] = p[9 + j];
  a.fx = p[12], a.fy = p[13], a.cx = p[14], a.cy = p[15];
  a.vsx = p[16], a.vsy = p[17], a.vsz = p[18];
  a.trunc = p[19], a.eta = p[20];
  const long long N = (long long)Z * Y * X;
  sobfu::integrate_live_kernel<<<sobfu::blocks_for(N), sobfu::kBlock, 0,
                                 (cudaStream_t)stream>>>(tsdf, weight, dists, tout, wout, a);
  return (int)cudaGetLastError();
}
