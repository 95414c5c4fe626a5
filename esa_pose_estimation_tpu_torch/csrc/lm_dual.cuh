// The arithmetic of the dual LM kernel (csrc/lm_dual.cu) beyond what it
// shares with RANSAC-EPnP (csrc/ransac_epnp.cuh: the problem, Kabsch, the
// mirror and the LM): the refine stage's weights, the mirror start pose,
// the heatmap evidence and the choice between the two candidates, as
// functions of one thread, host and device, so that the kernel and a host
// build of the same functions compute alike.
//
// Each follows pipeline.infer_poses_from_crops's refine stage and
// ops/pnp.py (mirror_pose, heatmap_evidence, lm_refine_dual) step by
// step in f32, with their constants and their order of operations; the
// compiler may fuse a multiply and an add.

#pragma once

#include <string.h>

#include "ransac_epnp.cuh"

namespace lmdual {

using repnp::Bits;
using repnp::Problem;

constexpr int kMaxCandidates = 2;   // the pose and its mirror

RE_HD int popcount(Bits m) {
#ifdef __CUDA_ARCH__
  return __popcll(m);
#else
  return __builtin_popcountll(m);
#endif
}

// The points the final refinement weights: RANSAC's inliers among the
// selection, or the selection where fewer than 4 of them are left.
RE_HD Bits kept(Bits sel, Bits inliers) {
  const Bits k = sel & inliers;
  return popcount(k) >= 4 ? k : sel;
}

// mirror_pose: the cloud R P + t reflected by mirror_cloud, then the
// weighted Kabsch fit of the model points onto it.  cam, mir: scratch of
// N x 3.
RE_HD void mirror_pose(const Problem& pr, const float* w, const float* R, const float* t,
                       float (*cam)[3], float (*mir)[3], float* Rm, float* tm) {
  float wsum = 0.0f;
  for (int n = 0; n < pr.n; ++n) {
    wsum += w[n];
    repnp::transform(R, t, pr.P[n], cam[n]);
  }
  repnp::mirror_cloud(w, pr.n, wsum, cam, mir);
  repnp::kabsch_fit(pr, w, mir, Rm, tm);
}

// A bf16 heatmap value, read as its bits.
struct Bf16 {
  unsigned short bits;
};

RE_HD float to_float(float v) { return v; }

RE_HD float to_float(Bf16 v) {
  const unsigned u = static_cast<unsigned>(v.bits) << 16;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// One keypoint's (S, S) heatmap, at strides sy and sx (elements).
template <typename T>
struct Map {
  const T* p;
  long long sy, sx;
  int S;

  // The value at (y, x) of the floor-rounded tap, zero outside the map.
  RE_HD float tap(float y, float x) const {
    if (!(x >= 0.0f && x < static_cast<float>(S) && y >= 0.0f && y < static_cast<float>(S))) {
      return 0.0f;
    }
    return to_float(p[static_cast<long long>(y) * sy + static_cast<long long>(x) * sx]);
  }
};

// heatmap_evidence's bilinear value of point n of the pose (R, t) on its
// map: reprojected to full-frame pixels, into the map by the crop's origin
// and the rate (crop rate over the heatmap stride), four taps.
template <typename T>
RE_HD float evidence_point(const Problem& pr, int n, const float* R, const float* t,
                           const Map<T>& map, float rate, float ox, float oy) {
  float p[3];
  repnp::transform(R, t, pr.P[n], p);
  const float z = repnp::clamp_min(p[2], 1e-6f);
  const float px = p[0] / z * pr.fx + pr.cx;
  const float py = p[1] / z * pr.fy + pr.cy;
  const float cxp = (px - ox) * rate;
  const float cyp = (py - oy) * rate;
  const float x0 = floorf(cxp), y0 = floorf(cyp);
  const float fxw = cxp - x0, fyw = cyp - y0;
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  return map.tap(y0, x0) * (1.0f - fxw) * (1.0f - fyw) + map.tap(y0, x1) * fxw * (1.0f - fyw)
         + map.tap(y1, x0) * (1.0f - fxw) * fyw + map.tap(y1, x1) * fxw * fyw;
}

// torch.argmax and torch.argmin of two values: a NaN wins, then the first
// among equals.
RE_HD int argmax2(const float* v) {
  if (v[0] != v[0]) return 0;
  if (v[1] != v[1]) return 1;
  return v[1] > v[0] ? 1 : 0;
}

RE_HD int argmin2(const float* v) {
  if (v[0] != v[0]) return 0;
  if (v[1] != v[1]) return 1;
  return v[1] < v[0] ? 1 : 0;
}

// lm_refine_dual's choice between the pose (0) and its mirror (1): the
// higher evidence, or the lower cost where there is no evidence or the
// two are tied within 1e-6 of the larger magnitude.
RE_HD int pick(const float* cost, const float* ev, bool evidence) {
  if (evidence) {
    const float m = fmaxf(fabsf(ev[0]), fabsf(ev[1]));
    if (!(fabsf(ev[0] - ev[1]) <= 1e-6f * (m + 1e-12f))) return argmax2(ev);
  }
  return argmin2(cost);
}

}  // namespace lmdual
