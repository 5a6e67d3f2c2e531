// The direct image pyramid in one launch: for every level [I, dx, dy]
// interleaved and |grad|^2 (optionally gamma-weighted), each level the 2x2
// mean of the one before.
//
// Replaces hslam_tpu/ops/pallas_kernels.py::_level_kernel (pallas_call at
// pallas_kernels.py:84), which the JAX package chains per level in
// build_direct_pyramid_pallas and then stacks [I, dx, dy] outside the
// kernel. The banded 0/1 matmul downsample of the TPU kernel
// (pallas_kernels.py:53-66) only existed because Mosaic rejected strided
// slices; it is not carried over.
//
// Bound: memory bandwidth. The function must read the frame once and write
// 12 B of [I, dx, dy] and 4 B of g2 per pixel of every level. Six levels of
// 480x640 hold 409,500 pixels: 6,552,000 B out, 307,200 B in for a uint8
// frame, 6.86 MB, 2.05 us at 3.35 TB/s (2.32 us for a float32 frame). The
// arithmetic (a few operations per pixel) is far below that.
//
// What the design does about it (pyramid_fused_kernel):
//  * One grid builds all levels, so the levels never wait for a launch and
//    no level's image is written to device memory to be read back as the
//    next one's input. A block owns a 32x32 tile of level 0 (origin a
//    multiple of 32) and loads it once with a halo of 8 pixels into shared
//    memory, converting uint8 or float32 on load (no cast copy), four
//    pixels a load where the rows are aligned. From shared memory it forms
//    the 16x16 tile of level 1 with a halo of 4, the 8x8 tile of level 2
//    with a halo of 2 and the 4x4 tile of level 3 with a halo of 1: one
//    pixel of halo at level 3 is two at level 2, four at level 1 and eight
//    at level 0, which is all the central difference of level 3 needs.
//    The tile is small on purpose: 480x640 gives 300 blocks of 256 threads
//    for 132 SMs, and the work of a block is a chain of short dependent
//    steps, so the card is filled by many blocks rather than by long ones
//    (64x64 tiles, 80 blocks, took 33 us on an H100).
//  * Stores of 16 bytes, neighbouring threads on neighbouring addresses.
//    A thread computes four neighbouring pixels from three float4 rows of
//    the shared tile: 12 floats of [I, dx, dy] and 4 of g2. g2 goes out as
//    one float4 per thread. The 12 floats of the 32 threads of a warp are
//    staged in the warp's own 1.5 KB of shared memory and leave as three
//    float4 per thread, consecutive threads on consecutive addresses
//    within a tile row. Rows are 16-byte aligned where the level's width is
//    a multiple of 4 (the wrapper aligns every sub-buffer); other widths
//    take a plain path with one float per thread.
//  * Levels 4 and up are 1/256 of the pixels. Each block stores its 2x2
//    piece of level 4's image, fences, and adds 1 to a counter in device
//    memory; the block that finds itself last computes level 4's gradients
//    and all further levels alone: in shared memory where level 4 fits
//    (up to 72 * 72 pixels, frames up to about 1150x1150), first all the
//    images and then all the outputs with no barrier between the levels;
//    through device memory otherwise. For a large frame (2160x3840 has a
//    135x240 level 4) that tail is one block's work: slow, but right. With
//    the hand-over at level 3 instead, that level alone cost the last block
//    2.8 us of a 12.7 us kernel at 480x640. A block counts before it
//    writes its outputs, so the count travels meanwhile. The last block
//    reads what the others wrote with ld.global.cg (__ldcg), never through
//    a const __restrict__ pointer, which the compiler may turn into the
//    non-coherent ld.global.nc. It sets the counter back to 0, so the
//    wrapper zeroes it once per device and stream, and again after an error.
//
// Semantics (hslam_tpu/ops/pyramid.py:46-113):
//   dx = 0.5 * (I[y, x+1] - I[y, x-1]), dy likewise; both 0 on the 1-px
//   border of the level (tested against the level's own H_l, W_l, never
//   against a tile's edge). g2 = dx^2 + dy^2, times w[clip(int(I), 0, 255)]^2
//   when a gamma weight is given (int() truncates toward zero, as
//   astype(int32) does). Level l+1 at (j, i) is
//   0.25 * ((a + b) + (c + d)) over I_l[2j:2j+2, 2i:2i+2], in that order so
//   that both routes give the same bits; an odd trailing row or column is
//   dropped, so a pixel that exists never reads one outside the image and
//   the masked (zero) part of a tile is never used. Any H, W >= 1, at most
//   8 levels.
//
// Where the time goes at 480x640, 6 levels, on an H100 at 700 W (~10 us, a
// fifth of the bound's rate): ~3 us is what one launch of this kernel takes
// on a 1x1 image, ~3.5 us the tiles and outputs of levels 0..3, ~3.5 us the
// hand-over and the tail, a chain of dependent trips to L2 (fence, count,
// read) and two small levels. Doing the tail while the other blocks still
// write, from shared memory of its own, gained 0.25 us and was not kept.
//
// pyramid_level_kernel, one launch per level with one thread per pixel, is
// the earlier design. It is kept as the timed yardstick and no path of the
// system calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Tiles of levels 0, 1, 2 in shared memory. A tile's pixel (0, 0) lies `halo`
// rows down and `kMargin` columns in, so that a group of 4 pixels is one
// aligned float4 at every level; the halo columns are the last `halo` of
// the margin and the first `halo` after the tile.
constexpr int kInTile = 4;                   // levels 0..3 are made tile by tile
constexpr int kMargin0 = 8, kMargin = 4;     // level 0; levels 1..3
constexpr int kTile0 = 32, kHalo0 = 8, kPitch0 = kTile0 + 2 * kMargin0;  // 48
constexpr int kTile1 = 16, kHalo1 = 4, kPitch1 = kTile1 + 2 * kMargin;   // 24
constexpr int kTile2 = 8, kHalo2 = 2, kPitch2 = kTile2 + 2 * kMargin;    // 16
constexpr int kTile3 = 4, kHalo3 = 1, kPitch3 = kTile3 + 2 * kMargin;    // 12
constexpr int kTile4 = 2;
constexpr int kRows0 = kTile0 + 2 * kHalo0, kRows1 = kTile1 + 2 * kHalo1,
              kRows2 = kTile2 + 2 * kHalo2, kRows3 = kTile3 + 2 * kHalo3;
// the last block keeps level 4 in shared memory up to this size, and the
// levels after it (a quarter each) behind it, each on a multiple of 16 bytes
constexpr int kTailPixels = 72 * 72;
constexpr int kTailFloats =
    kTailPixels + kTailPixels / 4 + kTailPixels / 16 + kTailPixels / 64 + 16;
constexpr int kStage = 32 * 12;              // floats a warp stages: 32 groups of 4 x [I, dx, dy]
static_assert(kRows0 * kPitch0 + kRows1 * kPitch1 + kRows2 * kPitch2 + kRows3 * kPitch3
                  <= kTailFloats, "the tiles share the tail's buffer");
static_assert(kInTile + 4 == kMaxLevels, "the tail holds four levels");

struct Levels {
  int n, H, W;                    // level l is (H >> l, W >> l)
  long long off3[kMaxLevels];     // float offsets of [I, dx, dy] in the buffer
  long long offg[kMaxLevels];     // float offsets of g2
};

// A level's image as the one-float-per-thread path reads it: shared memory
// whose pixel (0, 0) is `p` (a halo may lie at negative indices) ...
struct SmemSrc {
  const float* p;
  int pitch;
  __device__ float at(int y, int x) const { return p[y * pitch + x]; }
};

// ... or channel 0 of a level's [I, dx, dy] already in device memory,
// written by other blocks or earlier by this one: read through L2.
struct GlobalSrc {
  const float* p;
  int W;
  __device__ float at(int y, int x) const {
    return __ldcg(p + 3 * (static_cast<long long>(y) * W + x));
  }
};

__device__ __forceinline__ float gamma_weighted(float g, float v,
                                                const float* __restrict__ gamma_w) {
  if (gamma_w != nullptr) {
    // clamp in float first: identical to clip(trunc(v), 0, 255) for every
    // finite v, and never overflows the int conversion
    const int k = static_cast<int>(fminf(fmaxf(v, 0.0f), 255.0f));
    const float w = gamma_w[k];
    g = g * w * w;
  }
  return g;
}

// The plain path, any width: writes [I, dx, dy] and g2 of the tw x th pixels
// whose first is (x0, y0) of an H x W level, one float per thread and store;
// src.at(0, 0) is that first pixel. SKIP_I leaves channel 0 alone (it is
// what src reads).
template <bool SKIP_I, typename Src>
__device__ void emit_scalar(const Src src, int x0, int y0, int tw, int th, int H, int W,
                            float* out3, float* g2, const float* __restrict__ gamma_w) {
  if (tw <= 0 || th <= 0) return;
  const int nv = 3 * tw;
  for (int idx = threadIdx.x; idx < th * nv; idx += kThreads) {
    const int ty = idx / nv, j = idx - ty * nv;
    const int tx = j / 3, c = j - 3 * tx;
    const int x = x0 + tx, y = y0 + ty;
    float r = 0.0f;
    if (c == 0) {
      if (SKIP_I) continue;
      r = src.at(ty, tx);
    } else if (c == 1) {
      if (x > 0 && x < W - 1) r = 0.5f * (src.at(ty, tx + 1) - src.at(ty, tx - 1));
    } else {
      if (y > 0 && y < H - 1) r = 0.5f * (src.at(ty + 1, tx) - src.at(ty - 1, tx));
    }
    out3[3 * (static_cast<long long>(y) * W + x0) + j] = r;
  }
  for (int idx = threadIdx.x; idx < th * tw; idx += kThreads) {
    const int ty = idx / tw, tx = idx - ty * tw;
    const int x = x0 + tx, y = y0 + ty;
    float dx = 0.0f, dy = 0.0f;
    if (x > 0 && x < W - 1) dx = 0.5f * (src.at(ty, tx + 1) - src.at(ty, tx - 1));
    if (y > 0 && y < H - 1) dy = 0.5f * (src.at(ty + 1, tx) - src.at(ty - 1, tx));
    g2[static_cast<long long>(y) * W + x] =
        gamma_weighted(dx * dx + dy * dy, src.at(ty, tx), gamma_w);
  }
}

// The group path, W % 4 == 0: the four pixels (x..x+3, y) of an H x W level,
// x % 4 == 0, from `row`, their 16-byte aligned place in shared memory with
// the rows above and below `pitch` floats away. Writes g2 as one float4 and
// the 12 floats of [I, dx, dy] x 4 to `stage`. A neighbour outside the level
// is never read.
__device__ __forceinline__ void group4(const float* row, int pitch, int x, int y, int H, int W,
                                       float* g2, const float* __restrict__ gamma_w,
                                       float* stage) {
  const float4 c = *reinterpret_cast<const float4*>(row);
  float4 dx = make_float4(0.0f, 0.5f * (c.z - c.x), 0.5f * (c.w - c.y), 0.0f);
  float4 dy = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (x > 0) dx.x = 0.5f * (c.y - row[-1]);
  if (x + 4 < W) dx.w = 0.5f * (row[4] - c.z);
  if (y > 0 && y < H - 1) {
    const float4 u = *reinterpret_cast<const float4*>(row - pitch);
    const float4 d = *reinterpret_cast<const float4*>(row + pitch);
    dy = make_float4(0.5f * (d.x - u.x), 0.5f * (d.y - u.y), 0.5f * (d.z - u.z),
                     0.5f * (d.w - u.w));
  }
  float4* st = reinterpret_cast<float4*>(stage);
  st[0] = make_float4(c.x, dx.x, dy.x, c.y);
  st[1] = make_float4(dx.y, dy.y, c.z, dx.z);
  st[2] = make_float4(dy.z, c.w, dx.w, dy.w);
  *reinterpret_cast<float4*>(g2 + static_cast<long long>(y) * W + x) =
      make_float4(gamma_weighted(dx.x * dx.x + dy.x * dy.x, c.x, gamma_w),
                  gamma_weighted(dx.y * dx.y + dy.y * dy.y, c.y, gamma_w),
                  gamma_weighted(dx.z * dx.z + dy.z * dy.z, c.z, gamma_w),
                  gamma_weighted(dx.w * dx.w + dy.w * dy.w, c.w, gamma_w));
}

// One TILE x TILE tile (first pixel (x0, y0), stored at `tile` with `pitch`)
// of an H x W level, W % 4 == 0. A warp takes 32 groups at a time: 32 / G
// rows of G = TILE / 4 groups. `stage` is the warp's own kStage floats.
template <int TILE>
__device__ void emit_tile_groups(const float* tile, int pitch, int x0, int y0, int H, int W,
                                 float* out3, float* g2, const float* __restrict__ gamma_w,
                                 float* stage) {
  constexpr int G = TILE / 4;
  const int tw = min(TILE, W - x0), th = min(TILE, H - y0);
  if (tw <= 0 || th <= 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int first = 32 * warp; first < TILE * G; first += 32 * kWarps) {
    const int slot = first + lane;
    const int ty = slot / G, tx = 4 * (slot - ty * G);
    if (ty < th && tx < tw) {
      group4(tile + ty * pitch + tx, pitch, x0 + tx, y0 + ty, H, W, g2, gamma_w,
             stage + 12 * lane);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int f = 32 * i + lane;              // float4 f of the 96 staged
      const int seg = f / (3 * G), k = f - seg * (3 * G);
      const int sy = first / G + seg;
      if (sy < th && 4 * k < 3 * tw) {
        *reinterpret_cast<float4*>(out3 + 3 * (static_cast<long long>(y0 + sy) * W + x0) + 4 * k) =
            reinterpret_cast<const float4*>(stage)[f];
      }
    }
    __syncwarp();
  }
}

// A whole H x W level, W % 4 == 0, from shared memory with pitch W. Its rows
// follow each other in device memory, so the 32 groups of a warp leave as
// one run of 96 float4.
__device__ void emit_level_groups(const float* img, int H, int W, float* out3, float* g2,
                                  const float* __restrict__ gamma_w, float* stage) {
  const int gw = W >> 2, n_groups = H * gw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int first = 32 * warp; first < n_groups; first += 32 * kWarps) {
    const int slot = first + lane;
    if (slot < n_groups) {
      const int y = slot / gw, x = 4 * (slot - y * gw);
      group4(img + y * W + x, W, x, y, H, W, g2, gamma_w, stage + 12 * lane);
    }
    __syncwarp();
    const int n_f = 3 * min(32, n_groups - first);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int f = 32 * i + lane;
      if (f < n_f) {
        *reinterpret_cast<float4*>(out3 + 12 * static_cast<long long>(first) + 4 * f) =
            reinterpret_cast<const float4*>(stage)[f];
      }
    }
    __syncwarp();
  }
}

template <int TILE>
__device__ void emit_tile(const float* tile, int pitch, int x0, int y0, int H, int W,
                          float* out3, float* g2, const float* __restrict__ gamma_w,
                          float* stage) {
  if ((W & 3) == 0) {
    emit_tile_groups<TILE>(tile, pitch, x0, y0, H, W, out3, g2, gamma_w, stage);
  } else {
    emit_scalar<false>(SmemSrc{tile, pitch}, x0, y0, min(TILE, W - x0), min(TILE, H - y0),
                       H, W, out3, g2, gamma_w);
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const unsigned char* p) {
  const uchar4 u = __ldg(reinterpret_cast<const uchar4*>(p));
  return make_float4(u.x, u.y, u.z, u.w);
}

// dst = 2x2 means of src over an n x n patch (halo included). Patch pixel
// (0, 0) is src[ms] and dst[md]; ms is even, so a pair of source pixels is
// one aligned float2.
__device__ void down_tile(const float* src, int ps, int ms, float* dst, int pd, int md, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int qy = idx / n, qx = idx - qy * n;
    const float2 a = *reinterpret_cast<const float2*>(src + (2 * qy) * ps + ms + 2 * qx);
    const float2 b = *reinterpret_cast<const float2*>(src + (2 * qy + 1) * ps + ms + 2 * qx);
    dst[qy * pd + md + qx] = 0.25f * ((a.x + a.y) + (b.x + b.y));
  }
}

// Levels 4.. by the last block alone, level 4's image being complete in
// channel 0 of its [I, dx, dy]. Where level 4 fits `smem` (kTailFloats), all
// the images are formed there first, and then every level's outputs are
// written with no barrier between them; else level by level through device
// memory.
__device__ void tail_levels(float* buf, const Levels& L, const float* __restrict__ gamma_w,
                            float* smem, float* stage) {
  const int H4 = L.H >> kInTile, W4 = L.W >> kInTile;
  if (static_cast<long long>(H4) * W4 <= kTailPixels) {
    const float* img4 = buf + L.off3[kInTile];
    for (int idx = threadIdx.x; idx < H4 * W4; idx += kThreads) smem[idx] = __ldcg(img4 + 3 * idx);
    __syncthreads();
    float* cur = smem;
    for (int l = kInTile; l + 1 < L.n; ++l) {
      const int W = L.W >> l, Hn = L.H >> (l + 1), Wn = L.W >> (l + 1);
      float* nxt = cur + (((L.H >> l) * W + 3) & ~3);
      for (int idx = threadIdx.x; idx < Hn * Wn; idx += kThreads) {
        const int y = idx / Wn, x = idx - y * Wn;
        const float* r0 = cur + (2 * y) * W + 2 * x;
        nxt[idx] = 0.25f * ((r0[0] + r0[1]) + (r0[W] + r0[W + 1]));
      }
      __syncthreads();
      cur = nxt;
    }
    cur = smem;
    for (int l = kInTile; l < L.n; ++l) {
      const int H = L.H >> l, W = L.W >> l;
      if ((W & 3) == 0) {
        emit_level_groups(cur, H, W, buf + L.off3[l], buf + L.offg[l], gamma_w, stage);
      } else {
        emit_scalar<false>(SmemSrc{cur, W}, 0, 0, W, H, H, W, buf + L.off3[l], buf + L.offg[l],
                           gamma_w);
      }
      cur += (H * W + 3) & ~3;
    }
    return;
  }
  for (int l = kInTile; l < L.n; ++l) {
    const int H = L.H >> l, W = L.W >> l;
    float* out3 = buf + L.off3[l];
    const GlobalSrc src{out3, W};
    emit_scalar<true>(src, 0, 0, W, H, H, W, out3, buf + L.offg[l], gamma_w);
    if (l + 1 < L.n) {
      const int Hn = H >> 1, Wn = W >> 1;
      float* img_n = buf + L.off3[l + 1];
      for (long long idx = threadIdx.x; idx < static_cast<long long>(Hn) * Wn; idx += kThreads) {
        const int y = static_cast<int>(idx / Wn);
        const int x = static_cast<int>(idx - static_cast<long long>(y) * Wn);
        img_n[3 * idx] = 0.25f * ((src.at(2 * y, 2 * x) + src.at(2 * y, 2 * x + 1))
                                  + (src.at(2 * y + 1, 2 * x) + src.at(2 * y + 1, 2 * x + 1)));
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pyramid_fused_kernel(const T* __restrict__ img, float* buf, const Levels L,
                     const float* __restrict__ gamma_w, unsigned int* counter) {
  __shared__ __align__(16) float s_img[kTailFloats];     // the tiles; the tail's levels
  __shared__ __align__(16) float s_stage[kWarps * kStage];
  __shared__ bool s_last;
  float* s0 = s_img;
  float* s1 = s0 + kRows0 * kPitch0;
  float* s2 = s1 + kRows1 * kPitch1;
  float* s3 = s2 + kRows2 * kPitch2;
  float* stage = s_stage + kStage * (threadIdx.x >> 5);

  const int H = L.H, W = L.W;
  const int bx = blockIdx.x, by = blockIdx.y;
  const int px0 = bx * kTile0 - kMargin0, py0 = by * kTile0 - kHalo0;

  // the level-0 tile with its halo; zero outside the image
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(img) & (4 * sizeof(T) - 1)) == 0) {
    constexpr int kVecs = kPitch0 / 4;
    for (int idx = threadIdx.x; idx < kRows0 * kVecs; idx += kThreads) {
      const int py = idx / kVecs, pv = idx - py * kVecs;
      const int gy = py0 + py, gx = px0 + 4 * pv;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = load4(img + static_cast<long long>(gy) * W + gx);
      }
      *reinterpret_cast<float4*>(s0 + py * kPitch0 + 4 * pv) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows0 * kPitch0; idx += kThreads) {
      const int py = idx / kPitch0, px = idx - py * kPitch0;
      const int gy = py0 + py, gx = px0 + px;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = static_cast<float>(img[static_cast<long long>(gy) * W + gx]);
      }
      s0[idx] = v;
    }
  }
  __syncthreads();

  // All the tiles first, then the hand-over, then the outputs: the count of
  // this block travels while it writes, and the outputs of the four levels
  // need no barrier between them.
  const int n = L.n;
  if (n > 1) {
    down_tile(s0, kPitch0, kMargin0 - kHalo0, s1, kPitch1, kMargin - kHalo1, kRows1);
    __syncthreads();
  }
  if (n > 2) {
    down_tile(s1, kPitch1, kMargin - kHalo1, s2, kPitch2, kMargin - kHalo2, kRows2);
    __syncthreads();
  }
  if (n > 3) {
    down_tile(s2, kPitch2, kMargin - kHalo2, s3, kPitch3, kMargin - kHalo3, kRows3);
    __syncthreads();
  }
  if (n > kInTile) {
    // this block's 2x2 piece of level 4's image. The barrier orders the
    // block's stores before thread 0's fence, and the fence (cumulative)
    // before its count; the last block fences again before anyone reads.
    if (threadIdx.x < kTile4 * kTile4) {
      const int ty = threadIdx.x / kTile4, tx = threadIdx.x - ty * kTile4;
      const int H4 = H >> 4, W4 = W >> 4;
      const int y4 = by * kTile4 + ty, x4 = bx * kTile4 + tx;
      if (y4 < H4 && x4 < W4) {
        const float* r0 = s3 + (2 * ty + kHalo3) * kPitch3 + kMargin + 2 * tx;
        buf[L.off3[4] + 3 * (static_cast<long long>(y4) * W4 + x4)] =
            0.25f * ((r0[0] + r0[1]) + (r0[kPitch3] + r0[kPitch3 + 1]));
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      const unsigned int done = atomicAdd(counter, 1u);
      s_last = done == gridDim.x * gridDim.y - 1;
      if (s_last) {
        __threadfence();
        *counter = 0u;      // every block has counted: ready for the next launch
      }
    }
  }

  emit_tile<kTile0>(s0 + kHalo0 * kPitch0 + kMargin0, kPitch0, bx * kTile0, by * kTile0,
                    H, W, buf + L.off3[0], buf + L.offg[0], gamma_w, stage);
  if (n > 1) {
    emit_tile<kTile1>(s1 + kHalo1 * kPitch1 + kMargin, kPitch1, bx * kTile1, by * kTile1,
                      H >> 1, W >> 1, buf + L.off3[1], buf + L.offg[1], gamma_w, stage);
  }
  if (n > 2) {
    emit_tile<kTile2>(s2 + kHalo2 * kPitch2 + kMargin, kPitch2, bx * kTile2, by * kTile2,
                      H >> 2, W >> 2, buf + L.off3[2], buf + L.offg[2], gamma_w, stage);
  }
  if (n > 3) {
    emit_tile<kTile3>(s3 + kHalo3 * kPitch3 + kMargin, kPitch3, bx * kTile3, by * kTile3,
                      H >> 3, W >> 3, buf + L.off3[3], buf + L.offg[3], gamma_w, stage);
  }
  if (n <= kInTile) return;
  __syncthreads();            // s_last is written; the tiles are read
  if (!s_last) return;
  tail_levels(buf, L, gamma_w, s_img, stage);
}

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
  g2[i] = gamma_weighted(dx * dx + dy * dy, v, gamma_w);
  const int W2 = W >> 1, H2 = H >> 1;
  if (((x | y) & 1) == 0 && (x >> 1) < W2 && (y >> 1) < H2) {
    down[(y >> 1) * W2 + (x >> 1)] =
        0.25f * ((v + img[i + 1]) + (img[i + W] + img[i + W + 1]));
  }
}

}  // namespace

// All levels in one launch. `img` is H x W uint8 (is_u8) or float32; level
// l's [I, dx, dy] goes to buf + off3[l] and its g2 to buf + offg[l] (float
// offsets, each a multiple of 4, buf 16-byte aligned); `counter` is a
// device int32 that is 0 between launches on one stream.
extern "C" cudaError_t hslam_pyramid_fused(const void* img, int is_u8, float* buf,
                                           const long long* off3, const long long* offg,
                                           int n_levels, int H, int W,
                                           const float* gamma_w, unsigned int* counter,
                                           cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || H < 1 || W < 1 ||
      (H >> (n_levels - 1)) < 1 || (W >> (n_levels - 1)) < 1) {
    return cudaErrorInvalidValue;
  }
  Levels L;
  L.n = n_levels;
  L.H = H;
  L.W = W;
  for (int l = 0; l < kMaxLevels; ++l) {
    L.off3[l] = l < n_levels ? off3[l] : 0;
    L.offg[l] = l < n_levels ? offg[l] : 0;
  }
  const dim3 grid((W + kTile0 - 1) / kTile0, (H + kTile0 - 1) / kTile0);
  if (is_u8) {
    pyramid_fused_kernel<unsigned char><<<grid, kThreads, 0, stream>>>(
        static_cast<const unsigned char*>(img), buf, L, gamma_w, counter);
  } else {
    pyramid_fused_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(img), buf, L, gamma_w, counter);
  }
  return cudaGetLastError();
}

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
