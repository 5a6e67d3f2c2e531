// The tracker's coarse-to-fine LM (ops/tracker.track_coarse) and its
// hypothesis scoring (ops/tracker.score_hypotheses), each one launch, with
// no host read until the caller pulls the result.
//
// Replaces no Pallas kernel: the JAX package left the tracker to XLA
// (hslam_tpu/ops/tracker.py, one jitted while_loop per level). In PyTorch
// the same loop was host-launched: ~40 small operations and one host read
// an LM iteration, 6 levels and 32 hypotheses a frame, ~150 ms of host time
// for work a single SM does in well under a millisecond.
//
// Bound: latency, by a serial chain of residual passes. Each pass reads the
// level's template (17 B a point: u, v, idepth, colour, valid) and gathers
// four [I, dx, dy] neighbours a point (48 B), at most 8,192 points: ~0.53 MB,
// 0.16 us at 3.35 TB/s. But every pass depends on the step the pass before
// decided (accept or reject, lambda, convergence, cutoff doubling, abort,
// repeat), so the passes of one solve cannot overlap, and a frame's solve is
// ~40 of them. What the design does about it:
//  * The whole solve runs inside one thread block: no launch, no host read
//    and no round trip through device memory between passes. The LM's
//    scalar control flow runs on the device next to the sums that decide it.
//  * A pass: each thread takes template points in a strided loop, warps
//    them, gathers the four neighbours straight from the pyramid level
//    (H, W, 3) (with ix <= W-2 and iy <= H-2 these are the values of
//    ops/tracker.pack_pyramid_level's cells, so no packed copy is made), and
//    sums the 36 distinct entries of H, the 8 of b, E, n and n_sat in
//    registers. The block reduces with warp shuffles and then shared memory,
//    in a fixed order: no atomics, so a call gives the same bits every time.
//  * Thread 0 then solves the damped 8x8 system (LU with partial pivoting,
//    as getrf), takes the step, and tests and updates the state in shared
//    memory; the other threads wait at a barrier. All of it in float32 with
//    the arithmetic and clamps of _residual_pass, rel_affine and lie.se3_exp;
//    the thresholds a Python float compared against a float32 value in the
//    plain version are compared in double here too.
//  * Scoring: one block per hypothesis, the stated 10 fixed GN/LM iterations
//    at the coarsest level; the argmin is the caller's (torch.argmin), on
//    the device.
//  * The block size follows the template: the largest level's point count
//    rounded up to a warp, at most 512 threads (so at most 128 registers a
//    thread); level count and point counts are read from the arguments.
// The LM's iterations and cutoff doublings per level go to a small int
// record, which the caller folds into the pull it already makes.
//
// Compiled with -DHSLAM_HOST_EMULATION by a C++ compiler, the same source
// runs each block with one thread on the host (the CPU tests hold its
// control flow and arithmetic to the plain version there).

#ifdef HSLAM_HOST_EMULATION
#include <math.h>
#include <stdint.h>
namespace {
struct Idx { unsigned x = 0, y = 0, z = 0; };
thread_local Idx threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
// one thread per block: there is no other lane to read
inline float __shfl_down_sync(unsigned, float, int) { return 0.0f; }
}  // namespace
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __grid_constant__
#define __shared__ thread_local
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
#else
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#endif

// The arguments, outside the anonymous namespace: the C entries take them,
// and a type with internal linkage would hide those entries.
constexpr int kMaxLevels = 8;

// One pyramid level and its template. Mirrored by ops/tracker._Level.
struct Level {
  const float* u;
  const float* v;
  const float* idepth;
  const float* color;
  const unsigned char* valid;   // torch.bool
  const float* img;             // (H, W, 3) [I, dx, dy], contiguous
  const float* K;               // fx, fy, cx, cy of the level
  int n, H, W, max_iters;
};

// Mirrored by ops/tracker._Args.
struct TrackArgs {
  Level lv[kMaxLevels];
  int n_levels, coarsest, n_hyp, score_iters;
  const float* R0;              // (3, 3), or (n_hyp, 3, 3) for scoring
  const float* t0;              // (3,), or (n_hyp, 3)
  const float* aff0;            // (2,)
  const float* exp_ref;         // ()
  const float* exp_new;         // ()
  const float* aff_ref;         // (2,)
  const float* min_res;         // (n_min_res,), or null for no abort
  int n_min_res;
  float precond[8];
  double huber, cutoff;         // cfg.huber_th, cfg.coarse_cutoff_th
  float* out;                   // R 9, t 3, aff 2, residuals L, flow 3; scoring: (n_hyp,)
  unsigned char* ok;            // ()
  int* rec;                     // (2, L): LM iterations, cutoff doublings per level
};

namespace {

constexpr int kTemplateCap = 8192;           // ops/tracker.TEMPLATE_CAP
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNH = 36;                      // distinct entries of the symmetric 8x8 H
constexpr int kSys = 3 + kNH + 8;            // E, n, n_sat, H (upper, row-major), b
constexpr int kFin = 5;                      // E, n, shiftT, shiftRT, n_valid

// A pose to evaluate and its brightness map (rel_affine's a, b).
struct Eval {
  float R[9], t[3], a, b;
};

// The LM's accepted state and the system at it.
struct State {
  float R[9], t[3], aff[2];
  float sys[kSys];
  float lam;
};

// The block's shared memory.
struct Shared {
  Level lv[kMaxLevels];
  float red[kMaxWarps * kSys];
  float acc[kSys];
  State st;
  Eval ev;
  float cand[14];               // R 9, t 3, aff 2 of the step under test
  float inc[8];
  int flag;
};

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float z_safe(float z) { return fabsf(z) < 1e-12f ? 1e-12f : z; }
__device__ __forceinline__ int floor_index(float x, int hi) {
  // x is clamped to [0, hi + 0.999] or NaN; NaN gives 0
  int i = x >= 0.0f ? static_cast<int>(floorf(x)) : 0;
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// Sums v over the block in a fixed order into out[0..N); ends with a barrier.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * N + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    float s = red[k];
    for (int w = 1; w < nw; ++w) s += red[w * N + k];
    out[k] = s;
  }
  __syncthreads();
}

// _residual_pass of the pose in sh.ev over level L into sh.acc: the GN system
// (E, n, n_sat, H, b) or, FINAL, E, n and the flow sums.
template <bool FINAL>
__device__ void residual_pass(Shared& sh, const Level& level, float b0, float cutoff,
                              float huber, float max_energy) {
  constexpr int N = FINAL ? kFin : kSys;
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.0f;
  const Eval P = sh.ev;
  const Level L = level;
  const float fx = L.K[0], fy = L.K[1], cx = L.K[2], cy = L.K[3];
  const float hi_u = static_cast<float>(static_cast<double>(L.W) - 1.001);
  const float hi_v = static_cast<float>(static_cast<double>(L.H) - 1.001);
  const float lim_u = static_cast<float>(L.W - 3), lim_v = static_cast<float>(L.H - 3);
  for (int i = threadIdx.x; i < L.n; i += blockDim.x) {
    const float xs = L.u[i], ys = L.v[i], idp = L.idepth[i], refc = L.color[i];
    const bool valid = L.valid[i] != 0;
    const float px = (xs - cx) / fx;
    const float py = (ys - cy) / fy;
    const float X = P.R[0] * px + P.R[1] * py + P.R[2] + P.t[0] * idp;
    const float Y = P.R[3] * px + P.R[4] * py + P.R[5] + P.t[1] * idp;
    const float Z = P.R[6] * px + P.R[7] * py + P.R[8] + P.t[2] * idp;
    const float Zs = z_safe(Z);
    const float u = X / Zs, v = Y / Zs;
    const float Ku = fx * u + cx, Kv = fy * v + cy;
    const float nid = idp / Zs;
    bool mask = valid && Ku > 2.0f && Kv > 2.0f && Ku < lim_u && Kv < lim_v && nid > 0.0f;
    const float Kuc = clampf(Ku, 0.0f, hi_u), Kvc = clampf(Kv, 0.0f, hi_v);
    const int ix = floor_index(Kuc, L.W - 2), iy = floor_index(Kvc, L.H - 2);
    const float dxf = Kuc - static_cast<float>(ix), dyf = Kvc - static_cast<float>(iy);
    const float* c0 = L.img + 3 * (static_cast<long long>(iy) * L.W + ix);
    const float* c1 = c0 + 3 * static_cast<long long>(L.W);
    float hit[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float top = c0[c] * (1.0f - dxf) + c0[3 + c] * dxf;
      const float bot = c1[c] * (1.0f - dxf) + c1[3 + c] * dxf;
      hit[c] = top * (1.0f - dyf) + bot * dyf;
    }
    mask = mask && isfinite(hit[0]);
    const float r = hit[0] - (P.a * refc + P.b);
    const float ar = fabsf(r);
    const float hw = ar < huber ? 1.0f : huber / clamp_min(ar, 1e-12f);
    const bool sat = ar > cutoff && mask;
    const bool inl = mask && !sat;
    acc[0] += (inl ? hw * r * r * (2.0f - hw) : 0.0f) + (sat ? max_energy : 0.0f);
    acc[1] += mask ? 1.0f : 0.0f;
    if (!FINAL) {
      acc[2] += sat ? 1.0f : 0.0f;
      const float m = inl ? 1.0f : 0.0f;
      const float gdx = hit[1] * fx, gdy = hit[2] * fy;
      float J[8];
      J[0] = nid * gdx;
      J[1] = nid * gdy;
      J[2] = -nid * (u * gdx + v * gdy);
      J[3] = -(u * v * gdx + (1.0f + v * v) * gdy);
      J[4] = u * v * gdy + (1.0f + u * u) * gdx;
      J[5] = u * gdy - v * gdx;
      J[6] = P.a * (b0 - refc);
      J[7] = -1.0f;
      // weights as products, as the plain version's J * (hw * m): a masked
      // point with a non-finite entry poisons the system there too
      const float w = hw * m;
      const float rw = r * hw * m;
      int k = 3;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int b = a; b < 8; ++b) acc[k++] += J[a] * (J[b] * w);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) acc[3 + kNH + a] += J[a] * rw;
    } else {
      const float fm = valid ? 1.0f : 0.0f;
      const float tx = px + P.t[0] * idp, ty = py + P.t[1] * idp;
      const float tzs = z_safe(1.0f + P.t[2] * idp);
      const float KuT = fx * tx / tzs + cx, KvT = fy * ty / tzs + cy;
      const float tx2 = px - P.t[0] * idp, ty2 = py - P.t[1] * idp;
      const float tz2s = z_safe(1.0f - P.t[2] * idp);
      const float KuT2 = fx * tx2 / tz2s + cx, KvT2 = fy * ty2 / tz2s + cy;
      const float X3 = X - 2.0f * P.t[0] * idp, Y3 = Y - 2.0f * P.t[1] * idp;
      const float Z3s = z_safe(Z - 2.0f * P.t[2] * idp);
      const float Ku3 = fx * X3 / Z3s + cx, Kv3 = fy * Y3 / Z3s + cy;
      const float dT = (KuT - xs) * (KuT - xs) + (KvT - ys) * (KvT - ys) +
                       (KuT2 - xs) * (KuT2 - xs) + (KvT2 - ys) * (KvT2 - ys);
      const float dRT = (Ku - xs) * (Ku - xs) + (Kv - ys) * (Kv - ys) +
                        (Ku3 - xs) * (Ku3 - xs) + (Kv3 - ys) * (Kv3 - ys);
      acc[2] += fm * dT;
      acc[3] += fm * dRT;
      acc[4] += fm;
    }
  }
  block_sum<N>(acc, sh.red, sh.acc);
}

// (H + diag(H) lam) x = -b, H given by its upper triangle: LU with partial
// pivoting (the first largest pivot, as getrf). A singular system gives
// non-finite entries, never an error.
__device__ void solve8(const float* Hu, const float* b, float lam, float* x) {
  float A[8][9];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i; j < 8; ++j) {
      A[i][j] = Hu[k];
      A[j][i] = Hu[k];
      ++k;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    A[i][i] = A[i][i] + A[i][i] * lam;
    A[i][8] = -b[i];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int i = c + 1; i < 8; ++i) {
      const float m = fabsf(A[i][c]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
#pragma unroll
    for (int i = c + 1; i < 8; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = c; j < 9; ++j) {
          const float tmp = A[c][j];
          A[c][j] = A[i][j];
          A[i][j] = tmp;
        }
      }
    }
#pragma unroll
    for (int i = c + 1; i < 8; ++i) {
      const float f = A[i][c] / A[c][c];
#pragma unroll
      for (int j = c + 1; j < 9; ++j) A[i][j] -= f * A[c][j];
    }
  }
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    float s = A[i][8];
#pragma unroll
    for (int j = i + 1; j < 8; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

__device__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
    }
  }
}

// lie.se3_exp of xi = [v, w], then lie.se3_mul with (R, t): the step applied.
__device__ void step_pose(const float* xi, const float* R, const float* t, float* Rn, float* tn) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(clamp_min(th2, 0.0f));
  const bool small = th2 < 1e-8f;
  const float th2s = small ? 1.0f : th2, ths = small ? 1.0f : th;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(ths) / ths;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(ths)) / th2s;
  const float C = small ? static_cast<float>(1.0 / 6.0) - th2 / 120.0f
                        : (ths - sinf(ths)) / (th2s * ths);
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float W2[9], dR[9], V[9];
  matmul3(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    dR[k] = eye + A * W[k] + B * W2[k];
    V[k] = eye + B * W[k] + C * W2[k];
  }
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
  matmul3(dR, R, Rn);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] + dt[i];
  }
}

// sh.ev from a pose and its affine parameters (rel_affine).
__device__ void set_eval(Shared& sh, const TrackArgs& a, const float* R, const float* t,
                         const float* aff) {
  const float er = *a.exp_ref, en = *a.exp_new;
  const float t_ref = er == 0.0f ? 1.0f : er, t_new = en == 0.0f ? 1.0f : en;
  const float ar = expf(aff[0] - a.aff_ref[0]) * t_new / t_ref;
#pragma unroll
  for (int k = 0; k < 9; ++k) sh.ev.R[k] = R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) sh.ev.t[k] = t[k];
  sh.ev.a = ar;
  sh.ev.b = aff[1] - ar * a.aff_ref[1];
}

__device__ float max_energy(double huber, double cutoff) {
  return static_cast<float>(2.0 * huber * cutoff - huber * huber);
}

// The proposed step from the state's system (thread 0): inc into sh.inc,
// the moved pose into sh.cand and sh.ev. EXTRAP: track_coarse's
// extrapolation for small lambda; scoring takes the plain step.
template <bool EXTRAP>
__device__ void propose(Shared& sh, const TrackArgs& a) {
  State& st = sh.st;
  float inc[8];
  solve8(st.sys + 3, st.sys + 3 + kNH, st.lam, inc);
  if (EXTRAP) {
    const float lam = st.lam;
    const float ex = lam < 0.001f ? sqrtf(sqrtf(0.001f / clamp_min(lam, 1e-12f))) : 1.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) inc[k] = inc[k] * ex;
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += inc[k];
  if (!isfinite(s)) {
#pragma unroll
    for (int k = 0; k < 8; ++k) inc[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) sh.inc[k] = inc[k];
  step_pose(inc, st.R, st.t, sh.cand, sh.cand + 9);
  sh.cand[12] = st.aff[0] + inc[6];
  sh.cand[13] = st.aff[1] + inc[7];
  set_eval(sh, a, sh.cand, sh.cand + 9, sh.cand + 12);
}

// Accept or reject the step just evaluated (thread 0); the lambda schedule.
__device__ void decide(Shared& sh) {
  State& st = sh.st;
  const float* acc = sh.acc;
  const bool accept = acc[0] / fmaxf(acc[1], 1.0f) < st.sys[0] / fmaxf(st.sys[1], 1.0f);
  if (accept) {
#pragma unroll
    for (int k = 0; k < 9; ++k) st.R[k] = sh.cand[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) st.t[k] = sh.cand[9 + k];
    st.aff[0] = sh.cand[12];
    st.aff[1] = sh.cand[13];
    for (int k = 0; k < kSys; ++k) st.sys[k] = acc[k];
  }
  st.lam = accept ? st.lam * 0.5f : clamp_min(st.lam * 4.0f, 0.001f);
}

__device__ void take_system(Shared& sh) {
  for (int k = 0; k < kSys; ++k) sh.st.sys[k] = sh.acc[k];
}

struct LevelOut {
  float rmse, flow[3];
  int cut_doubled;              // 0: the level kept the base cutoff
};

// run_level of track_coarse: cutoff doubling, the LM under the level's cap,
// the final pass with flow. Every thread calls it and gets the same result.
__device__ LevelOut run_level(Shared& sh, const TrackArgs& a, int lvl) {
  const Level& L = sh.lv[lvl];
  const bool lead = threadIdx.x == 0;
  const float huber = static_cast<float>(a.huber);
  const float b0 = a.aff_ref[1];
  double cut_rep = 1.0;
  if (lead) set_eval(sh, a, sh.st.R, sh.st.t, sh.st.aff);
  __syncthreads();
  residual_pass<false>(sh, L, b0, static_cast<float>(a.cutoff), huber,
                       max_energy(a.huber, a.cutoff));
  if (lead) take_system(sh);
  int doubled = 0;
  // adaptive cutoff doubling (CoarseTracker.cpp:530-539)
  while (static_cast<double>(sh.acc[2] / fmaxf(sh.acc[1], 1.0f)) > 0.6 && cut_rep < 50.0) {
    cut_rep *= 2.0;
    ++doubled;
    const double cut = a.cutoff * cut_rep;
    residual_pass<false>(sh, L, b0, static_cast<float>(cut), huber, max_energy(a.huber, cut));
    if (lead) take_system(sh);
  }
  const double cut = a.cutoff * cut_rep;
  const float cutoff = static_cast<float>(cut), emax = max_energy(a.huber, cut);
  if (lead) sh.st.lam = 0.01f;
  int iters = 0;
  for (int it = 0; it < L.max_iters; ++it) {
    ++iters;
    if (lead) propose<true>(sh, a);
    __syncthreads();
    residual_pass<false>(sh, L, b0, cutoff, huber, emax);
    if (lead) {
      decide(sh);
      // convergence in the reference's scaled units (CoarseTracker.cpp:640)
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float q = sh.inc[k] / a.precond[k];
        s += q * q;
      }
      sh.flag = static_cast<double>(sqrtf(s)) <= 1e-3;
    }
    __syncthreads();
    if (sh.flag) break;
  }
  if (lead) {
    set_eval(sh, a, sh.st.R, sh.st.t, sh.st.aff);
    a.rec[lvl] += iters;
    a.rec[a.n_levels + lvl] += doubled;
  }
  __syncthreads();
  residual_pass<true>(sh, L, b0, cutoff, huber, emax);
  LevelOut o;
  o.rmse = sqrtf(sh.acc[0] / fmaxf(sh.acc[1], 1.0f));
  o.flow[0] = sh.acc[2] / (2.0f * sh.acc[4] + 0.1f);
  o.flow[1] = 0.0f;
  o.flow[2] = sh.acc[3] / (2.0f * sh.acc[4] + 0.1f);
  o.cut_doubled = doubled;
  __syncthreads();              // every thread has read sh.acc
  return o;
}

__device__ void load_levels(Shared& sh, const TrackArgs& a) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) sh.lv[l] = a.lv[l];
  }
}

__global__ void __launch_bounds__(kMaxThreads) track_coarse_kernel(const __grid_constant__ TrackArgs a) {
  __shared__ Shared sh;
  const bool lead = threadIdx.x == 0;
  const int L = a.n_levels;
  load_levels(sh, a);
  if (lead) {
#pragma unroll
    for (int k = 0; k < 9; ++k) sh.st.R[k] = a.R0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sh.st.t[k] = a.t0[k];
    sh.st.aff[0] = a.aff0[0];
    sh.st.aff[1] = a.aff0[1];
    for (int l = 0; l < L; ++l) {
      a.out[14 + l] = nanf("");
      a.rec[l] = 0;
      a.rec[L + l] = 0;
    }
    a.out[14 + L] = 1000.0f;
    a.out[15 + L] = 0.0f;
    a.out[16 + L] = 1000.0f;
  }
  __syncthreads();
  bool ok = true, repeated = false;
  for (int lvl = a.coarsest; lvl >= 0 && ok; --lvl) {
    LevelOut o = run_level(sh, a, lvl);
    const int al = lvl < a.n_min_res - 1 ? lvl : a.n_min_res - 1;
    const double thr = a.min_res == nullptr ? INFINITY : static_cast<double>(a.min_res[al]);
    ok = !(static_cast<double>(o.rmse) > 1.5 * thr);
    // repeat-level-once (CoarseTracker.cpp:654-659)
    if (ok && o.cut_doubled > 0 && !repeated) {
      repeated = true;
      o = run_level(sh, a, lvl);
    }
    if (lead) {
      a.out[14 + lvl] = o.rmse;
      for (int k = 0; k < 3; ++k) a.out[14 + L + k] = o.flow[k];
    }
  }
  if (lead) {
    for (int k = 0; k < 9; ++k) a.out[k] = sh.st.R[k];
    for (int k = 0; k < 3; ++k) a.out[9 + k] = sh.st.t[k];
    a.out[12] = sh.st.aff[0];
    a.out[13] = sh.st.aff[1];
    *a.ok = ok && fabsf(sh.st.aff[0]) <= 1.2f && fabsf(sh.st.aff[1]) <= 200.0f;
  }
}

// score_hypotheses: block h runs hypothesis h's fixed iterations at the
// coarsest level and writes E/n, or inf where it diverged or n < 4.
__global__ void __launch_bounds__(kMaxThreads) track_score_kernel(const __grid_constant__ TrackArgs a) {
  __shared__ Shared sh;
  const bool lead = threadIdx.x == 0;
  const int h = blockIdx.x;
  load_levels(sh, a);
  __syncthreads();
  const Level& L = sh.lv[a.coarsest];
  const float huber = static_cast<float>(a.huber), cutoff = static_cast<float>(a.cutoff);
  const float emax = max_energy(a.huber, a.cutoff), b0 = a.aff_ref[1];
  if (lead) {
#pragma unroll
    for (int k = 0; k < 9; ++k) sh.st.R[k] = a.R0[9 * h + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sh.st.t[k] = a.t0[3 * h + k];
    sh.st.aff[0] = a.aff0[0];
    sh.st.aff[1] = a.aff0[1];
    sh.st.lam = 0.01f;
    set_eval(sh, a, sh.st.R, sh.st.t, sh.st.aff);
  }
  __syncthreads();
  residual_pass<false>(sh, L, b0, cutoff, huber, emax);
  if (lead) take_system(sh);
  for (int it = 0; it < a.score_iters; ++it) {
    if (lead) propose<false>(sh, a);
    __syncthreads();
    residual_pass<false>(sh, L, b0, cutoff, huber, emax);
    if (lead) decide(sh);
  }
  if (lead) {
    const float E = sh.st.sys[0], n = sh.st.sys[1];
    const float mean_e = E / fmaxf(n, 1.0f);
    a.out[h] = (!isfinite(mean_e) || n < 4.0f) ? INFINITY : mean_e;
  }
}

// The levels lo..hi are those the kernel reads.
bool args_ok(const TrackArgs& a, int lo, int hi) {
  if (a.n_levels < 1 || a.n_levels > kMaxLevels || a.coarsest < 0 || a.coarsest >= a.n_levels) {
    return false;
  }
  if (a.min_res != nullptr && a.n_min_res < 1) return false;
  for (int l = lo; l <= hi; ++l) {
    const Level& L = a.lv[l];
    if (L.n < 0 || L.n > kTemplateCap || L.H < 2 || L.W < 2 || L.max_iters < 0) return false;
  }
  return true;
}

}  // namespace

extern "C" int hslam_track_args_size() { return static_cast<int>(sizeof(TrackArgs)); }

#ifdef HSLAM_HOST_EMULATION
// Each block in turn, with one thread.
extern "C" cudaError_t hslam_track_coarse(const TrackArgs* a, cudaStream_t) {
  if (!args_ok(*a, 0, a->coarsest)) return cudaErrorInvalidValue;
  blockDim.x = 1;
  blockIdx.x = 0;
  threadIdx.x = 0;
  track_coarse_kernel(*a);
  return cudaSuccess;
}

extern "C" cudaError_t hslam_track_score(const TrackArgs* a, cudaStream_t) {
  if (!args_ok(*a, a->coarsest, a->coarsest) || a->n_hyp < 1) return cudaErrorInvalidValue;
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int h = 0; h < a->n_hyp; ++h) {
    blockIdx.x = h;
    track_score_kernel(*a);
  }
  return cudaSuccess;
}
#else
// The point count of the largest of levels lo..hi rounded up to a warp,
// at most kMaxThreads.
static int block_threads(const TrackArgs& a, int lo, int hi) {
  int n = 32;
  for (int l = lo; l <= hi; ++l) n = a.lv[l].n > n ? a.lv[l].n : n;
  n = (n + 31) / 32 * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

extern "C" cudaError_t hslam_track_coarse(const TrackArgs* a, cudaStream_t stream) {
  if (!args_ok(*a, 0, a->coarsest)) return cudaErrorInvalidValue;
  track_coarse_kernel<<<1, block_threads(*a, 0, a->coarsest), 0, stream>>>(*a);
  return cudaGetLastError();
}

extern "C" cudaError_t hslam_track_score(const TrackArgs* a, cudaStream_t stream) {
  if (!args_ok(*a, a->coarsest, a->coarsest) || a->n_hyp < 1) return cudaErrorInvalidValue;
  track_score_kernel<<<a->n_hyp, block_threads(*a, a->coarsest, a->coarsest), 0, stream>>>(*a);
  return cudaGetLastError();
}
#endif
