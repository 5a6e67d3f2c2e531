// One level of the direct image pyramid, fused: [I, dx, dy] interleaved,
// |grad|^2 (optionally gamma-weighted) and the next level's 2x2 mean.
//
// Replaces hslam_tpu/ops/pallas_kernels.py::_level_kernel (pallas_call at
// pallas_kernels.py:84), which the JAX package chains per level in
// build_direct_pyramid_pallas and then stacks [I, dx, dy] outside the
// kernel. Here the stack and the gamma-LUT gather are folded into the
// stores, so each level is read once and written once.
//
// Bound: memory bandwidth. A 640x480 6-level pyramid reads ~1.6 MB and
// writes ~7 MB (12 B of [I, dx, dy] + 4 B of g2 per pixel, plus the
// quarter-size next level), about 2.6 us of HBM time at 3.35 TB/s. At that
// size the six launches (one per level, each depending on the previous
// level's output) cost more than the bytes; a single-launch design that
// keeps the whole pyramid in one grid is later work. One thread per output
// pixel; neighbouring threads read neighbouring addresses, and the
// stencil's re-reads of the 3x3 neighbourhood hit L1/L2.
//
// The banded 0/1 matmul downsample of the TPU kernel
// (pallas_kernels.py:53-66) only existed because Mosaic rejected strided
// slices; it is not carried over.
//
// Semantics (hslam_tpu/ops/pyramid.py:46-113):
//   dx = 0.5 * (I[y, x+1] - I[y, x-1]), dy likewise; both 0 on the 1-px
//   border. g2 = dx^2 + dy^2, times w[clip(int(I), 0, 255)]^2 when a gamma
//   weight is given (int() truncates toward zero, as astype(int32) does).
//   down[j, i] = mean of I[2j:2j+2, 2i:2i+2]; an odd trailing row or column
//   is dropped. Any H, W >= 1.

#include <cuda_runtime.h>

namespace {

__global__ void pyramid_level_kernel(const float* __restrict__ img,
                                     float* __restrict__ out3,
                                     float* __restrict__ g2,
                                     float* __restrict__ down,
                                     const float* __restrict__ gamma_w,
                                     int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int i = y * W + x;
  const float v = img[i];
  float dx = 0.0f, dy = 0.0f;
  if (x > 0 && x < W - 1) dx = 0.5f * (img[i + 1] - img[i - 1]);
  if (y > 0 && y < H - 1) dy = 0.5f * (img[i + W] - img[i - W]);
  out3[3 * i + 0] = v;
  out3[3 * i + 1] = dx;
  out3[3 * i + 2] = dy;
  float g = dx * dx + dy * dy;
  if (gamma_w != nullptr) {
    // clamp in float first: identical to clip(trunc(v), 0, 255) for every
    // finite v, and never overflows the int conversion
    const int k = static_cast<int>(fminf(fmaxf(v, 0.0f), 255.0f));
    const float w = gamma_w[k];
    g = g * w * w;
  }
  g2[i] = g;
  const int W2 = W >> 1, H2 = H >> 1;
  if (((x | y) & 1) == 0 && (x >> 1) < W2 && (y >> 1) < H2) {
    down[(y >> 1) * W2 + (x >> 1)] =
        0.25f * ((v + img[i + 1]) + (img[i + W] + img[i + W + 1]));
  }
}

}  // namespace

extern "C" cudaError_t hslam_pyramid_level(const float* img, float* out3,
                                           float* g2, float* down,
                                           const float* gamma_w, int H, int W,
                                           cudaStream_t stream) {
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  pyramid_level_kernel<<<grid, block, 0, stream>>>(img, out3, g2, down,
                                                   gamma_w, H, W);
  return cudaGetLastError();
}
