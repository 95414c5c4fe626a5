// A host build of the dual LM kernel's arithmetic
// (esa_pose_estimation_tpu_torch/csrc/lm_dual.cuh and ransac_epnp.cuh): a
// problem's phases in order on one thread, the candidates in turn, the
// kernel's reductions as sums in point order.  The CPU tests compare it
// with ops/pnp.refine_pose_plain.
//
//   g++ -std=c++17 -O1 -shared -fPIC -I <csrc> -o liblm_dual_host.so lm_dual_host.cpp

#include "lm_dual.cuh"

using namespace repnp;
using namespace lmdual;

namespace {

// heatmap_evidence of one candidate over the selected points, from the
// problem's contiguous (S, S, N) maps.
template <typename T>
float candidate_evidence(const Problem& pr, Bits sel, const T* maps, int S, float rate,
                         float ox, float oy, const float* R, const float* t) {
  float ev = 0.0f;
  for (int n = 0; n < pr.n; ++n) {
    if (!has(sel, n)) continue;
    const Map<T> map{maps + n, static_cast<long long>(S) * pr.n, pr.n, S};
    ev += evidence_point(pr, n, R, t, map, rate, ox, oy);
  }
  return ev;
}

}  // namespace

// Inputs contiguous per problem: p3 (B, N, 3), p2 (B, N, 2), K (B, 3, 3),
// conf (B, N), sel and inl (B, N) or null, R0 (B, 3, 3), t0 (B, 3), and
// null or the heatmaps (B, S, S, N), f32 or the bits of bf16, with rates
// (B,) and int32 origins (B, 2).  Outputs: R (B, 3, 3), t (B, 3), the
// candidate kept (B,), and each candidate's final cost and evidence (B, 2).
extern "C" int lm_dual_host(const float* p3, const float* p2, const float* K,
                            const float* conf, const unsigned char* sel,
                            const unsigned char* inl, const float* R0, const float* t0,
                            const void* hm, int hm_bf16, int S, const float* rates,
                            const int* origins, long long B, int N, int iters, int ncand,
                            float* R_out, float* t_out, unsigned char* picked,
                            float* cost_out, float* ev_out) {
  if (B < 1 || N < 1 || N > kMaxPoints || iters < 0 || ncand < 1 || ncand > kMaxCandidates
      || (hm != nullptr && S < 1)) {
    return -1;
  }
  static Problem pr;
  static float cam[kMaxPoints][3], mir[kMaxPoints][3];
  for (long long b = 0; b < B; ++b) {
    const float* k = K + 9 * b;
    pr.fx = k[0];
    pr.fy = k[4];
    pr.cx = k[2];
    pr.cy = k[5];
    pr.n = N;
    Bits s = 0, i = 0;
    for (int n = 0; n < N; ++n) {
      for (int d = 0; d < 3; ++d) pr.P[n][d] = p3[(b * N + n) * 3 + d];
      for (int d = 0; d < 2; ++d) pr.px[n][d] = p2[(b * N + n) * 2 + d];
      normalize_point(pr, n);
      if (sel == nullptr || sel[b * N + n]) s |= 1ull << n;
      if (inl == nullptr || inl[b * N + n]) i |= 1ull << n;
    }
    const Bits keep = kept(s, i);
    float w[kMaxPoints];
    for (int n = 0; n < N; ++n) w[n] = has(keep, n) ? conf[b * N + n] : 0.0f;

    float R[kMaxCandidates][9], t[kMaxCandidates][3];
    float cost[kMaxCandidates] = {0.0f, 0.0f}, ev[kMaxCandidates] = {0.0f, 0.0f};
    for (int j = 0; j < 9; ++j) R[0][j] = R0[b * 9 + j];
    for (int j = 0; j < 3; ++j) t[0][j] = t0[b * 3 + j];
    if (ncand == 2) mirror_pose(pr, w, R[0], t[0], cam, mir, R[1], t[1]);
    const long long hm_b = b * S * S * N;
    for (int c = 0; c < ncand; ++c) {
      cost[c] = 0.5f * lm_refine(pr, w, iters, 0, 1, GroupSum(), R[c], t[c]);
      if (hm == nullptr || ncand == 1) continue;
      const float rate = rates[b];
      const float ox = static_cast<float>(origins[2 * b]);
      const float oy = static_cast<float>(origins[2 * b + 1]);
      ev[c] = hm_bf16
                  ? candidate_evidence(pr, s, static_cast<const Bf16*>(hm) + hm_b, S, rate, ox,
                                       oy, R[c], t[c])
                  : candidate_evidence(pr, s, static_cast<const float*>(hm) + hm_b, S, rate,
                                       ox, oy, R[c], t[c]);
    }
    const int kk = ncand == 1 ? 0 : pick(cost, ev, hm != nullptr);
    for (int j = 0; j < 9; ++j) R_out[b * 9 + j] = R[kk][j];
    for (int j = 0; j < 3; ++j) t_out[b * 3 + j] = t[kk][j];
    picked[b] = static_cast<unsigned char>(kk);
    for (int c = 0; c < kMaxCandidates; ++c) {
      cost_out[2 * b + c] = cost[c];
      ev_out[2 * b + c] = ev[c];
    }
  }
  return 0;
}
