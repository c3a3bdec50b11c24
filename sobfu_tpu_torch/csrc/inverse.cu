// Kernel C: n steps of the inverse-field fixed point q <- v - disp(psi)(q).
//
// Replaces sobfu_tpu/ops/pallas_kernels.py estimate_inverse_window_pallas_multi
// (:3061, body _make_inverse_multi_kernel :2974) and the step-chained
// estimate_inverse_window_pallas (:1883); in exact mode (K < 0) it is the
// reference's 48-step estimate_inverse (vector_fields.cu:111-138).
//
// Each voxel iterates on its own: q(v) depends only on q(v) and on the
// constant field psi, so all n steps run inside one launch with no grid
// synchronisation. disp = psi - identity is formed at each corner on the fly
// (the same f32 subtraction the plain version makes up front, so the
// corners' values are the plain version's bits), and no displacement volume
// is written. The three channels share one Taps3 per step.
//
// Bound on the H100: at 128^3 with 3 warm steps memory, 0.0225 ms for psi
// and init read once and q written once (75 MB at 3.35 TB/s); 48 exact steps
// are bound by their float operations (~0.12 ms at 67 TFLOP/s). What the
// kernel pays beyond that is
// the latency of its dependent gathers: step s + 1 cannot issue its 24
// corner loads before step s has finished; the corners lie within K voxels
// (window) or near the solved field (exact), so they mostly hit L1/L2.
// Design (inverse_kernel, after kernel B's):
//   - exactness and the warm start (init != null) are template parameters,
//     so the taps and the blend carry no run-time branch (taps3_t, and
//     trilinear with a constant exactness);
//   - 32-bit voxel arithmetic: one division chain of the voxel index, corner
//     offsets ints inside a channel, 64 bits only for the channel bases; the
//     entry point refuses volumes of 2^31 voxels or more;
//   - a thread takes kPer voxels one block width apart, its steps unrolled
//     over them, so kPer dependent gather chains are in flight per thread
//     and each of a warp's loads of psi, init and q stays on 32 consecutive
//     voxels.
// Measured on an H100 80GB HBM3 at 700 W (torch.profiler, device time per
// launch; parent and variants in turns, tools/bench_torch_kernels.py): the
// kernel before (one voxel a thread, 64-bit division and indexing, run-time
// exactness) 0.1026-0.1052 ms for 3 warm steps at 128^3, K=2, 0.0149-0.0150
// at 64^3, K=1, 1.232-1.242 for 48 exact steps at 128^3. This form, by kPer
// (voxels a thread): 1: 0.0671 / 0.0100 / 0.828; 2 (kept): 0.0668-0.0675 /
// 0.0097-0.0099 / 0.752-0.758; 4: 0.0689 / 0.0105 / 0.839. Most of the gain
// is the compile-time sampler and the 32-bit index; what is left is the 24
// corner loads a step (L1 wavefronts of scattered gathers, ~3 T loads/s).
// Loading the two x corners as one 8-byte pair was not tried: the pair is
// aligned for even i0 only.
#include "sampling.cuh"

namespace sobfu {

template <bool kExact, bool kInit, int kPer>
__global__ void __launch_bounds__(kBlock)
    inverse_kernel(const float* __restrict__ psi, const float* __restrict__ init,
                   float* __restrict__ out, int Z, int Y, int X, int K, float hi, int n_steps) {
  const unsigned N = (unsigned)Z * Y * X;
  const unsigned base = blockIdx.x * (kBlock * kPer) + threadIdx.x;
  const float* __restrict__ px = psi;
  const float* __restrict__ py = psi + N;
  const float* __restrict__ pz = psi + 2 * (size_t)N;
  float qx[kPer], qy[kPer], qz[kPer];
  int vx[kPer], vy[kPer], vz[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned i = min(base + j * kBlock, N - 1);  // a voxel past the end repeats the last
    const unsigned row = i / X;
    vx[j] = (int)(i - row * X);
    vz[j] = (int)(row / Y);
    vy[j] = (int)(row - (unsigned)vz[j] * Y);
    if (kInit) {
      qx[j] = __ldg(init + i);
      qy[j] = __ldg(init + N + i);
      qz[j] = __ldg(init + 2 * (size_t)N + i);
    } else {
      qx[j] = (float)vx[j];
      qy[j] = (float)vy[j];
      qz[j] = (float)vz[j];
    }
  }
  for (int s = 0; s < n_steps; ++s) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const Taps3 t = taps3_t<kExact>(qx[j], qy[j], qz[j], vx[j], vy[j], vz[j], Z, Y, X, K, hi);
      const float ax = trilinear(t, kExact, [&](int xi, int yi, int zi) {
        return __ldg(px + ((zi * Y + yi) * X + xi)) - (float)xi;
      });
      const float ay = trilinear(t, kExact, [&](int xi, int yi, int zi) {
        return __ldg(py + ((zi * Y + yi) * X + xi)) - (float)yi;
      });
      const float az = trilinear(t, kExact, [&](int xi, int yi, int zi) {
        return __ldg(pz + ((zi * Y + yi) * X + xi)) - (float)zi;
      });
      qx[j] = (float)vx[j] - ax;
      qy[j] = (float)vy[j] - ay;
      qz[j] = (float)vz[j] - az;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned i = base + j * kBlock;
    if (i >= N) continue;
    out[i] = qx[j];
    out[N + i] = qy[j];
    out[2 * (size_t)N + i] = qz[j];
  }
}

// voxels a thread (a block width apart)
constexpr int kInversePer = 2;

template <bool kExact, bool kInit>
void launch_inverse(const float* psi, const float* init, float* out, int Z, int Y, int X, int K,
                    float hi, int n_steps, cudaStream_t st) {
  const int blocks = blocks_for(((long long)Z * Y * X + kInversePer - 1) / kInversePer);
  inverse_kernel<kExact, kInit, kInversePer><<<blocks, kBlock, 0, st>>>(psi, init, out, Z, Y, X,
                                                                        K, hi, n_steps);
}

}  // namespace sobfu

// psi, out f32[3,Z,Y,X]; init f32[3,Z,Y,X] or null (identity); K < 0 = exact.
// Z*Y*X < 2^31.
extern "C" int sobfu_inverse_fixed_point(const float* psi, const float* init, float* out,
                                         int Z, int Y, int X, int K, int n_steps,
                                         void* stream) {
  using namespace sobfu;
  const long long N = (long long)Z * Y * X;
  if (N < 1 || N >= (1ll << 31) || n_steps < 0) return (int)cudaErrorInvalidValue;
  const float hi = (float)((double)K - 1e-4);
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 0)
    init != nullptr ? launch_inverse<true, true>(psi, init, out, Z, Y, X, K, hi, n_steps, st)
                    : launch_inverse<true, false>(psi, init, out, Z, Y, X, K, hi, n_steps, st);
  else
    init != nullptr ? launch_inverse<false, true>(psi, init, out, Z, Y, X, K, hi, n_steps, st)
                    : launch_inverse<false, false>(psi, init, out, Z, Y, X, K, hi, n_steps, st);
  return (int)cudaGetLastError();
}
