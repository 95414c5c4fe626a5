// RANSAC-EPnP for Hopper (sm_90a): the whole of ops/pnp.ransac_epnp, one
// launch for a batch of problems.  Sampling, every hypothesis's EPnP and
// score, the choice of the best, the refit on its inliers and the LM
// refinement run in one CTA per problem; nothing goes back to device
// memory between them.
//
// Replaces no Pallas kernel: the JAX solver (esa_pose_estimation_tpu/
// ops/pnp.py ransac_epnp) is jnp under jit, which XLA fuses.  Its plain
// PyTorch version, ops/pnp.ransac_epnp_plain, is the same straight-line
// tensor code, which on the card runs as ~7,300 kernels of a few scalars
// each for one problem.  The arithmetic is in csrc/ransac_epnp.cuh.
//
// Bound on this card: neither bytes (~8 KB in and a few hundred bytes out
// a problem) nor operations (~0.7 MFLOP a problem): the length of the
// dependent chain of one problem.  A hypothesis is a 12x12 Cholesky, four
// substitutions and its reprojection; the refit another Cholesky with
// four right-hand sides, four beta refinements and two polar iterations;
// the LM ten 6x6 solves.  The design keeps that chain short and lets the
// problems and hypotheses run side by side:
//
// * one CTA per problem; its points, normalised keypoints, barycentric
//   coordinates and control-frame distances are computed once into
//   shared memory;
// * one thread per hypothesis (the block strides over more): its 12x12
//   system, Cholesky factor and null vector live in its registers, so a
//   hypothesis needs no barrier and no shuffle; 64 hypotheses run as two
//   warps side by side, and at batch 256 the card holds every CTA at once;
// * the choice is a warp reduction over the threads' best (score, index),
//   in torch.argmax's order;
// * the refit's 78 entries of M^T M are summed by 78 threads, its solve
//   runs on one thread, and the LM on one warp: the lanes own the points,
//   the sums go through a butterfly (every lane ends with the same bits),
//   and every lane takes the same 6x6 step.
//
// Built without fast math: logf, IEEE division and square root keep the
// Gumbel keys and the thresholds bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ransac_epnp.cuh"

using namespace repnp;

namespace {

constexpr int kMaxThreads = 256;   // threads per CTA, at most
constexpr int kMinThreads = 96;    // enough for the 78 entries of M^T M
constexpr int kErrShape = -1;      // a size outside what the kernel takes

struct Args {
  const float* p3;          // (B, N, 3), batch stride p3_stride
  const float* p2;          // (B, N, 2) pixels
  const float* K;           // (B, 3, 3)
  const unsigned char* valid;   // (B, N) bool, or null: all valid
  const float* samples;     // (B, H, N) uniforms, or masks if `masks`
  const float* basis;       // the start bases, 12 x 1 then 12 x 4
  long long p3_stride, p2_stride, k_stride, valid_stride, samples_stride;
  int n, h, sample, lm_iters, masks, refine;
  float thr, score_div;
  float* R;                 // (B, 3, 3)
  float* t;                 // (B, 3)
  unsigned char* inliers;   // (B, N) bool
  float* cost;              // (B,)
  unsigned char* chosen;    // (B, N) bool: the best hypothesis's inliers, or null
};

__global__ void __launch_bounds__(kMaxThreads) ransac_epnp_kernel(const Args a) {
  __shared__ Problem pr;
  __shared__ float s_score[kMaxThreads];
  __shared__ int s_hyp[kMaxThreads];
  __shared__ Bits s_inl[kMaxThreads];
  __shared__ unsigned char s_valid[kMaxPoints];
  __shared__ float s_w[kMaxPoints];
  __shared__ float s_m[78];
  __shared__ float s_cam[kMaxPoints][3];
  __shared__ float s_mir[kMaxPoints][3];
  __shared__ float s_R[9], s_t[3];

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int N = a.n;

  // ---- the problem, read once
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
    s_valid[n] = a.valid == nullptr ? 1 : (a.valid[b * a.valid_stride + n] != 0);
  }
  __syncthreads();
  if (tid == 0) {
    Bits v = 0;
    for (int n = 0; n < N; ++n) v |= static_cast<Bits>(s_valid[n]) << n;
    pr.valid = v;
    control_frame(pr);
  }
  __syncthreads();
  for (int n = tid; n < N; n += T) barycentric(pr, n);
  __syncthreads();

  // ---- the hypotheses, one a thread
  float best = 0.0f;
  int best_h = -1;
  Bits best_inl = 0;
  const float* rows = a.samples + b * a.samples_stride;
  for (int h = tid; h < a.h; h += T) {
    const float* row = rows + static_cast<long long>(h) * N;
    float score;
    Bits inl;
    if (a.refine) {
      hypothesis<4>(pr, a.masks ? row : nullptr, row, a.sample, a.basis + 12, a.thr,
                    a.score_div, &score, &inl);
    } else {
      hypothesis<1>(pr, a.masks ? row : nullptr, row, a.sample, a.basis, a.thr,
                    a.score_div, &score, &inl);
    }
    if (best_h < 0 || better(score, h, best, best_h)) {
      best = score;
      best_h = h;
      best_inl = inl;
    }
  }
  s_score[tid] = best;
  s_hyp[tid] = best_h;
  s_inl[tid] = best_inl;
  __syncthreads();

  // ---- the best hypothesis (warp 0), and the refit's weights
  if (tid < 32) {
    float bs = 0.0f;
    int bh = -1;
    for (int i = tid; i < T; i += 32) {
      if (s_hyp[i] >= 0 && (bh < 0 || better(s_score[i], s_hyp[i], bs, bh))) {
        bs = s_score[i];
        bh = s_hyp[i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oh = __shfl_xor_sync(0xffffffffu, bh, off);
      if (oh >= 0 && (bh < 0 || better(os, oh, bs, bh))) {
        bs = os;
        bh = oh;
      }
    }
    // the winner is the best of the thread that ran it
    const Bits inl = s_inl[bh % T];
    const bool enough = __popcll(inl) >= 4;
    for (int n = tid; n < N; n += 32) {
      s_w[n] = (enough ? has(inl, n) : has(pr.valid, n)) ? 1.0f : 0.0f;
      if (a.chosen != nullptr) a.chosen[b * N + n] = has(inl, n) ? 1 : 0;
    }
  }
  __syncthreads();

  // ---- the refit: M^T M by entries, then the solve on one thread
  for (int e = tid; e < 78; e += T) s_m[e] = mtm_entry(pr, s_w, e);
  __syncthreads();
  if (tid == 0) refit(pr, s_w, s_m, a.basis + 12, s_cam, s_mir, s_R, s_t);
  __syncthreads();

  // ---- LM on warp 0: lanes own points, every lane takes the same step
  if (tid < 32) {
    float R[9], t[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = s_R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = s_t[i];
    const float sq = lm_refine(pr, s_w, a.lm_iters, tid, 32, GroupSum(), R, t);
    for (int n = tid; n < N; n += 32) {
      a.inliers[b * N + n] = final_inlier(pr, n, R, t, a.thr) ? 1 : 0;
    }
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) a.R[b * 9 + i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) a.t[b * 3 + i] = t[i];
      a.cost[b] = 0.5f * sq;
    }
  }
}

int block_threads(int h) {
  const int t = (h + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// One launch over B problems; see Args for the layouts.  masks != 0: the
// samples are (B, H, N) weights; else uniforms, whose Gumbel top-`sample`
// over the valid points is each hypothesis's sample.  refine != 0: beta
// refinement in every hypothesis (sample < 6).  chosen: null, or (B, N)
// for the best hypothesis's inliers.
extern "C" int ransac_epnp_launch(
    const float* p3, long long p3_stride, const float* p2, long long p2_stride,
    const float* K, long long k_stride, const unsigned char* valid, long long valid_stride,
    const float* samples, long long samples_stride, int masks, const float* basis,
    long long B, int N, int H, int sample, int lm_iters, int refine, float thr,
    float score_div, float* R, float* t, unsigned char* inliers, float* cost,
    unsigned char* chosen, void* stream) {
  if (B < 1 || B >= (1LL << 31) || N < 1 || N > kMaxPoints || H < 1 || lm_iters < 0
      || (!masks && (sample < 1 || sample > N))) {
    return kErrShape;
  }
  Args a;
  a.p3 = p3;
  a.p2 = p2;
  a.K = K;
  a.valid = valid;
  a.samples = samples;
  a.basis = basis;
  a.p3_stride = p3_stride;
  a.p2_stride = p2_stride;
  a.k_stride = k_stride;
  a.valid_stride = valid_stride;
  a.samples_stride = samples_stride;
  a.n = N;
  a.h = H;
  a.sample = sample;
  a.lm_iters = lm_iters;
  a.masks = masks;
  a.refine = refine;
  a.thr = thr;
  a.score_div = score_div;
  a.R = R;
  a.t = t;
  a.inliers = inliers;
  a.cost = cost;
  a.chosen = chosen;
  ransac_epnp_kernel<<<static_cast<unsigned>(B), block_threads(H), 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
