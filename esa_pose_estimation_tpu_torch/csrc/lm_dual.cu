// The serving path's final refinement for Hopper (sm_90a): the refine
// stage of pipeline.infer_poses_from_crops in one launch for a batch of
// problems.  Per problem: the weights (RANSAC's inliers among the
// selection, or the selection, times the confidences), the pose's
// weak-perspective mirror, LM on both candidates side by side, each
// candidate's heatmap evidence read straight from the network's maps, and
// the choice between them.  One candidate (no mirror) where the caller
// does not disambiguate; the choice by cost alone without heatmaps.
//
// Replaces no Pallas kernel: the JAX refinement (esa_pose_estimation_tpu/
// ops/pnp.py lm_refine_dual, heatmap_evidence) is jnp under jit, which XLA
// fuses.  Its plain PyTorch version, ops/pnp.refine_pose_plain, is the same
// straight-line tensor code, which on the card runs as ~2,000 kernels of a
// few scalars each for one problem, and at batch 256 writes a permuted f32
// copy of every heatmap (0.5 GB) to read 4 taps of each keypoint from it.
// The arithmetic is in csrc/lm_dual.cuh and csrc/ransac_epnp.cuh.
//
// Bound on this card: neither bytes (~1.5 KB in a problem, 240 heatmap
// taps) nor operations (~0.1 MFLOP a problem): the dependent chain of one
// problem, ten 6x6 solves in a row.  The design keeps that chain short:
//
// * one CTA per problem, one warp per candidate, so the two LM runs go
//   side by side; the problem and the weights are read once into shared
//   memory;
// * the mirror's Kabsch fit runs on one lane of the mirror's warp while
//   the other warp starts on the pose;
// * the lanes own the points, the LM's sums and the evidence go through a
//   butterfly (every lane ends with the same bits), every lane takes the
//   same 6x6 step;
// * the choice is made by one thread once both warps are done.
//
// Built without fast math: IEEE division and square root, as the plain
// version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lm_dual.cuh"

using namespace repnp;
using namespace lmdual;

namespace {

constexpr int kErrShape = -1;   // a size outside what the kernel takes

struct Args {
  const float* p3;              // (B, N, 3)
  const float* p2;              // (B, N, 2) pixels
  const float* K;               // (B, 3, 3)
  const float* conf;            // (B, N) confidences
  const unsigned char* sel;     // (B, N) bool, or null: every point
  const unsigned char* inl;     // (B, N) bool, or null: no inlier set
  const float* R0;              // (B, 3, 3)
  const float* t0;              // (B, 3)
  const void* hm;               // (B, S, S, N) f32 or bf16 at strides, or null
  const float* rates;           // (B,) heatmap pixels per frame pixel
  const int* origins;           // (B, 2) crop origin
  long long p3_stride, p2_stride, k_stride, conf_stride, sel_stride, inl_stride,
      r0_stride, t0_stride, rates_stride, origins_stride;
  long long hm_sb, hm_sy, hm_sx, hm_sk;
  int n, iters, ncand, hm_bf16, S;
  float* R;                     // (B, 3, 3)
  float* t;                     // (B, 3)
  unsigned char* picked;        // (B,) the candidate kept, or null
};

template <typename T>
__device__ float evidence(const Args& a, const Problem& pr, const unsigned char* sel,
                          long long b, int lane, const float* R, const float* t) {
  const float rate = a.rates[b * a.rates_stride];
  const int* o = a.origins + b * a.origins_stride;
  const float ox = static_cast<float>(o[0]), oy = static_cast<float>(o[1]);
  const T* base = static_cast<const T*>(a.hm) + b * a.hm_sb;
  float ev = 0.0f;
  for (int n = lane; n < pr.n; n += 32) {
    if (!sel[n]) continue;
    const Map<T> map{base + n * a.hm_sk, a.hm_sy, a.hm_sx, a.S};
    ev += evidence_point(pr, n, R, t, map, rate, ox, oy);
  }
  return GroupSum()(ev);
}

__global__ void __launch_bounds__(32 * kMaxCandidates) lm_dual_kernel(const Args a) {
  __shared__ Problem pr;
  __shared__ float s_w[kMaxPoints];
  __shared__ unsigned char s_sel[kMaxPoints];
  __shared__ unsigned char s_inl[kMaxPoints];
  __shared__ Bits s_keep;
  __shared__ float s_cam[kMaxPoints][3];
  __shared__ float s_mir[kMaxPoints][3];
  __shared__ float s_R[kMaxCandidates][9], s_t[kMaxCandidates][3];
  __shared__ float s_cost[kMaxCandidates], s_ev[kMaxCandidates];

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int N = a.n;

  // ---- the problem and the weights, read once
  if (tid == 0) {
    const float* k = a.K + b * a.k_stride;
    pr.fx = k[0];
    pr.fy = k[4];
    pr.cx = k[2];
    pr.cy = k[5];
    pr.n = N;
  }
  __syncthreads();
  for (int n = tid; n < N; n += T) {
    const float* p3 = a.p3 + b * a.p3_stride + 3 * n;
    const float* p2 = a.p2 + b * a.p2_stride + 2 * n;
    pr.P[n][0] = p3[0];
    pr.P[n][1] = p3[1];
    pr.P[n][2] = p3[2];
    pr.px[n][0] = p2[0];
    pr.px[n][1] = p2[1];
    normalize_point(pr, n);
    s_sel[n] = a.sel == nullptr ? 1 : (a.sel[b * a.sel_stride + n] != 0);
    s_inl[n] = a.inl == nullptr ? 1 : (a.inl[b * a.inl_stride + n] != 0);
  }
  __syncthreads();
  if (tid == 0) {
    Bits sel = 0, inl = 0;
    for (int n = 0; n < N; ++n) {
      sel |= static_cast<Bits>(s_sel[n]) << n;
      inl |= static_cast<Bits>(s_inl[n]) << n;
    }
    s_keep = kept(sel, inl);
  }
  __syncthreads();
  for (int n = tid; n < N; n += T) {
    s_w[n] = has(s_keep, n) ? a.conf[b * a.conf_stride + n] : 0.0f;
  }
  __syncthreads();

  // ---- one warp a candidate: the pose, and its mirror
  const int c = tid >> 5;
  const int lane = tid & 31;
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = a.R0[b * a.r0_stride + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = a.t0[b * a.t0_stride + i];
  if (c == 1) {
    if (lane == 0) mirror_pose(pr, s_w, R, t, s_cam, s_mir, s_R[1], s_t[1]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = s_R[1][i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = s_t[1][i];
    __syncwarp();
  }
  const float sq = lm_refine(pr, s_w, a.iters, lane, 32, GroupSum(), R, t);
  float ev = 0.0f;
  if (a.hm != nullptr && a.ncand == 2) {
    ev = a.hm_bf16 ? evidence<Bf16>(a, pr, s_sel, b, lane, R, t)
                   : evidence<float>(a, pr, s_sel, b, lane, R, t);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) s_R[c][i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) s_t[c][i] = t[i];
    s_cost[c] = 0.5f * sq;
    s_ev[c] = ev;
  }
  __syncthreads();

  // ---- the choice
  if (tid < 12) {
    const int k = a.ncand == 1 ? 0 : pick(s_cost, s_ev, a.hm != nullptr);
    if (tid < 9) {
      a.R[b * 9 + tid] = s_R[k][tid];
    } else {
      a.t[b * 3 + tid - 9] = s_t[k][tid - 9];
    }
    if (tid == 0 && a.picked != nullptr) a.picked[b] = static_cast<unsigned char>(k);
  }
}

}  // namespace

// One launch over B problems of N points; see Args for the layouts.
// ncand: 1 (LM on the pose) or 2 (the pose and its mirror, one kept).
// hm: null, or the (B, S, S, N) heatmaps at element strides hm_s*, bf16
// where hm_bf16 != 0; then rates and origins place each problem's crop.
// picked: null, or (B,) for the candidate kept.
extern "C" int lm_dual_launch(
    const float* p3, long long p3_stride, const float* p2, long long p2_stride,
    const float* K, long long k_stride, const float* conf, long long conf_stride,
    const unsigned char* sel, long long sel_stride, const unsigned char* inl,
    long long inl_stride, const float* R0, long long r0_stride, const float* t0,
    long long t0_stride, const void* hm, int hm_bf16, long long hm_sb, long long hm_sy,
    long long hm_sx, long long hm_sk, int S, const float* rates, long long rates_stride,
    const int* origins, long long origins_stride, long long B, int N,
    int iters, int ncand, float* R, float* t, unsigned char* picked, void* stream) {
  if (B < 1 || B >= (1LL << 31) || N < 1 || N > kMaxPoints || iters < 0 || ncand < 1
      || ncand > kMaxCandidates || (hm != nullptr && S < 1)) {
    return kErrShape;
  }
  Args a;
  a.p3 = p3;
  a.p2 = p2;
  a.K = K;
  a.conf = conf;
  a.sel = sel;
  a.inl = inl;
  a.R0 = R0;
  a.t0 = t0;
  a.hm = hm;
  a.rates = rates;
  a.origins = origins;
  a.p3_stride = p3_stride;
  a.p2_stride = p2_stride;
  a.k_stride = k_stride;
  a.conf_stride = conf_stride;
  a.sel_stride = sel_stride;
  a.inl_stride = inl_stride;
  a.r0_stride = r0_stride;
  a.t0_stride = t0_stride;
  a.rates_stride = rates_stride;
  a.origins_stride = origins_stride;
  a.hm_sb = hm_sb;
  a.hm_sy = hm_sy;
  a.hm_sx = hm_sx;
  a.hm_sk = hm_sk;
  a.n = N;
  a.iters = iters;
  a.ncand = ncand;
  a.hm_bf16 = hm_bf16;
  a.S = S;
  a.R = R;
  a.t = t;
  a.picked = picked;
  lm_dual_kernel<<<static_cast<unsigned>(B), 32 * ncand, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
