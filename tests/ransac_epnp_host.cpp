// A host build of the RANSAC-EPnP kernel's arithmetic
// (esa_pose_estimation_tpu_torch/csrc/ransac_epnp.cuh): the kernel's
// phases run in order on one thread, each problem after the other, with
// the kernel's reductions as sums in point order.  The CPU tests compare
// it with ops/pnp.ransac_epnp_plain.
//
//   g++ -std=c++17 -O1 -shared -fPIC -I <csrc> -o libhost.so ransac_epnp_host.cpp

#include "ransac_epnp.cuh"

using namespace repnp;

// Inputs contiguous per problem: p3 (B, N, 3), p2 (B, N, 2), K (B, 3, 3),
// valid (B, N) or null, samples (B, H, N); the kernel's outputs, with
// the best hypothesis's inliers (B, N).
extern "C" int ransac_epnp_host(const float* p3, const float* p2, const float* K,
                                const unsigned char* valid, const float* samples,
                                int masks, const float* basis, long long B, int N,
                                int H, int sample, int lm_iters, int refine, float thr,
                                float score_div, float* R_out, float* t_out,
                                unsigned char* inl_out, float* cost_out,
                                unsigned char* chosen_out) {
  if (B < 1 || N < 1 || N > kMaxPoints || H < 1 || lm_iters < 0
      || (!masks && (sample < 1 || sample > N))) {
    return -1;
  }
  static Problem pr;
  for (long long b = 0; b < B; ++b) {
    const float* k = K + 9 * b;
    pr.fx = k[0];
    pr.fy = k[4];
    pr.cx = k[2];
    pr.cy = k[5];
    pr.n = N;
    pr.valid = 0;
    for (int n = 0; n < N; ++n) {
      for (int d = 0; d < 3; ++d) pr.P[n][d] = p3[(b * N + n) * 3 + d];
      for (int d = 0; d < 2; ++d) pr.px[n][d] = p2[(b * N + n) * 2 + d];
      normalize_point(pr, n);
      if (valid == nullptr || valid[b * N + n]) pr.valid |= 1ull << n;
    }
    control_frame(pr);
    for (int n = 0; n < N; ++n) barycentric(pr, n);

    float best = 0.0f;
    int best_h = -1;
    Bits best_inl = 0;
    for (int h = 0; h < H; ++h) {
      const float* row = samples + (b * H + h) * N;
      float score;
      Bits inl;
      if (refine) {
        hypothesis<4>(pr, masks ? row : nullptr, row, sample, basis + 12, thr, score_div,
                      &score, &inl);
      } else {
        hypothesis<1>(pr, masks ? row : nullptr, row, sample, basis, thr, score_div,
                      &score, &inl);
      }
      if (best_h < 0 || better(score, h, best, best_h)) {
        best = score;
        best_h = h;
        best_inl = inl;
      }
    }
    const bool enough = __builtin_popcountll(best_inl) >= 4;
    float w[kMaxPoints];
    for (int n = 0; n < N; ++n) {
      w[n] = (enough ? has(best_inl, n) : has(pr.valid, n)) ? 1.0f : 0.0f;
      chosen_out[b * N + n] = has(best_inl, n);
    }
    float m[78];
    for (int e = 0; e < 78; ++e) m[e] = mtm_entry(pr, w, e);
    float cam[kMaxPoints][3], mir[kMaxPoints][3], R[9], t[3];
    refit(pr, w, m, basis + 12, cam, mir, R, t);

    const float sq = lm_refine(pr, w, lm_iters, 0, 1, GroupSum(), R, t);
    for (int n = 0; n < N; ++n) inl_out[b * N + n] = final_inlier(pr, n, R, t, thr) ? 1 : 0;
    for (int i = 0; i < 9; ++i) R_out[b * 9 + i] = R[i];
    for (int i = 0; i < 3; ++i) t_out[b * 3 + i] = t[i];
    cost_out[b] = 0.5f * sq;
  }
  return 0;
}

// The refit alone (epnp_from_mask with beta refinement) of one problem on
// the weights w (N,): R (3, 3), t (3,).
extern "C" int epnp_refit_host(const float* p3, const float* p2, const float* K,
                               const float* w, const float* basis, int N, float* R,
                               float* t) {
  if (N < 1 || N > kMaxPoints) return -1;
  static Problem pr;
  pr.fx = K[0];
  pr.fy = K[4];
  pr.cx = K[2];
  pr.cy = K[5];
  pr.n = N;
  pr.valid = 0;
  for (int n = 0; n < N; ++n) {
    for (int d = 0; d < 3; ++d) pr.P[n][d] = p3[n * 3 + d];
    for (int d = 0; d < 2; ++d) pr.px[n][d] = p2[n * 2 + d];
    normalize_point(pr, n);
  }
  control_frame(pr);
  for (int n = 0; n < N; ++n) barycentric(pr, n);
  float m[78];
  for (int e = 0; e < 78; ++e) m[e] = mtm_entry(pr, w, e);
  float cam[kMaxPoints][3], mir[kMaxPoints][3];
  refit(pr, w, m, basis + 12, cam, mir, R, t);
  return 0;
}

