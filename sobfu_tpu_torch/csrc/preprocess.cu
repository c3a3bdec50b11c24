// Kernel P: the frame's depth preprocessing in one pass — the bilateral
// filter, the optional depth truncation and the metric ray lengths ("dists").
//
// Computes what sobfu_tpu_torch/ops/frontend.py preprocess_depth_plain
// computes (ops/imgproc.py bilateral_filter -> truncate_depth ->
// compute_dists; in the JAX package the same chain is XLA,
// sobfu_tpu/ops/imgproc.py:48-121, and has no TPU kernel). The plain chain
// is about 25 launches a tap of the k x k window, each over the whole map;
// here one thread takes one pixel, and a block stages its tile of the depth
// map with the k - 1 halo in shared memory.
//
// Bits: the taps are summed in the plain version's order (dy outer over
// [-r, k - r), dx inner), each sum1 += nb * w and sum2 += w a rounded
// multiply and a rounded add (--fmad=false). The spatial term of a tap is
// the float rounding of the double (dx^2 + dy^2) * sig_space, as torch
// rounds a Python scalar added to a float tensor; the colour term is
// (d - nb)^2 * sig_color with sig_color rounded to float. A tap is valid
// when its row lies in [0, H - 2] and its column in [0, W - 2] (the
// reference excludes the last row and column); an invalid tap adds nothing
// (the plain version adds nb * 0). The mean is rounded half to even; a
// window whose weights all underflow is 0 / 0, which converts to 0 mm, as
// the plain version's cast does on the card.
//
// Bound on the H100: the float operations (about ten a tap, 49 taps at the
// ini's k = 7); the bytes are 4 in and 4 out a pixel.
#include <cuda_runtime.h>

namespace sobfu {

constexpr int kPreTileX = 32;
constexpr int kPreTileY = 8;

struct PreprocessArgs {
  int H, W, k;
  double sig_space;
  float sig_color;
  int max_mm;  // < 0: no truncation
  float fx, fy, cx, cy;
};

__global__ void preprocess_depth_kernel(const int* __restrict__ depth, float* __restrict__ dists,
                                        PreprocessArgs a) {
  extern __shared__ float smem[];
  const int k = a.k, r = k / 2;
  const int tw = kPreTileX + k - 1, th = kPreTileY + k - 1;
  float* tile = smem;              // th x tw depths, the block's pixels at (r, r)
  float* space = smem + tw * th;   // k x k spatial terms
  const int tid = threadIdx.y * kPreTileX + threadIdx.x;
  const int x0 = blockIdx.x * kPreTileX - r, y0 = blockIdx.y * kPreTileY - r;
  for (int i = tid; i < tw * th; i += kPreTileX * kPreTileY) {
    const int gy = y0 + i / tw, gx = x0 + i % tw;
    tile[i] = (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) ? (float)depth[gy * a.W + gx] : 0.0f;
  }
  for (int i = tid; i < k * k; i += kPreTileX * kPreTileY) {
    const int dy = i / k - r, dx = i % k - r;
    space[i] = __double2float_rn((double)(dx * dx + dy * dy) * a.sig_space);
  }
  __syncthreads();
  const int x = blockIdx.x * kPreTileX + threadIdx.x;
  const int y = blockIdx.y * kPreTileY + threadIdx.y;
  if (x >= a.W || y >= a.H) return;

  const float* centre = tile + (threadIdx.y + r) * tw + threadIdx.x + r;
  const float d = centre[0];
  float sum1 = 0.0f, sum2 = 0.0f;
  for (int dy = -r; dy < k - r; ++dy) {
    const int ny = y + dy;
    if (ny < 0 || ny > a.H - 2) continue;
    for (int dx = -r; dx < k - r; ++dx) {
      const int nx = x + dx;
      if (nx < 0 || nx > a.W - 2) continue;
      const float nb = centre[dy * tw + dx];
      const float diff = d - nb;
      const float w = expf(-(space[(dy + r) * k + dx + r] + diff * diff * a.sig_color));
      sum1 = sum1 + nb * w;
      sum2 = sum2 + w;
    }
  }
  int mm = (int)rintf(sum1 / sum2);
  if (a.max_mm >= 0 && mm > a.max_mm) mm = 0;
  const float xl = ((float)x - a.cx) / a.fx;
  const float yl = ((float)y - a.cy) / a.fy;
  const float lam = sqrtf((xl * xl + yl * yl) + 1.0f);
  dists[y * a.W + x] = ((float)mm * lam) * 0.001f;
}

}  // namespace sobfu

// depth int32[H, W] in mm, dists f32[H, W] in metres; k the window width;
// sig_space = 0.5 / sigma_spatial^2 (double, as the plain version's Python
// scalar), sig_color = 0.5 / (sigma_depth * 1000)^2 rounded to float;
// max_mm < 0 leaves the depth untruncated; intr = (fx, fy, cx, cy).
extern "C" int sobfu_preprocess_depth(const int* depth, float* dists, int H, int W, int k,
                                      double sig_space, float sig_color, int max_mm,
                                      const float* intr, void* stream) {
  sobfu::PreprocessArgs a{H, W, k, sig_space, sig_color, max_mm,
                          intr[0], intr[1], intr[2], intr[3]};
  const dim3 block(sobfu::kPreTileX, sobfu::kPreTileY);
  const dim3 grid((W + sobfu::kPreTileX - 1) / sobfu::kPreTileX,
                  (H + sobfu::kPreTileY - 1) / sobfu::kPreTileY);
  const size_t shared =
      sizeof(float) * ((sobfu::kPreTileX + k - 1) * (sobfu::kPreTileY + k - 1) + k * k);
  sobfu::preprocess_depth_kernel<<<grid, block, shared, (cudaStream_t)stream>>>(depth, dists, a);
  return (int)cudaGetLastError();
}
