// The arithmetic of the RANSAC-EPnP kernel (csrc/ransac_epnp.cu): every
// step of one problem as a function of one thread, host and device, so
// that the kernel and a host build of the same functions compute alike.
// The dual LM kernel (csrc/lm_dual.cu) shares the problem, the mirror,
// the Kabsch fit and the LM.
//
// Each function follows ops/pnp.py, ops/epnp.py and core/linalg.py step
// by step, in f32, with their constants (ridges, clamps, the 1e-6 depth
// floors, the LM's damping schedule and accept rule) and their order of
// subtraction where it is fixed there (Cholesky, substitutions,
// Gram-Schmidt).  Sums over points run in point order; torch may take
// them in another order, and the compiler may fuse a multiply and an add:
// those are the only differences.  Points of weight 0 are skipped, which
// adds nothing for finite inputs.

#pragma once

#include <math.h>

// RE_UNROLL: loops whose indices must be constants for the arrays to stay
// in registers.  RE_ROLLED: iterations of a whole step, kept as a loop so
// that the code stays small: a thread runs most of it once, and a kernel
// fully unrolled fetches more instructions than it executes twice.
#ifdef __CUDACC__
#define RE_HD __host__ __device__ __forceinline__
#define RE_UNROLL _Pragma("unroll")
#define RE_ROLLED _Pragma("unroll 1")
#else
#define RE_HD inline
#define RE_UNROLL
#define RE_ROLLED
#endif

namespace repnp {

constexpr int kMaxPoints = 64;     // points per problem, at most
constexpr float kEps = 1e-9f;      // ops/epnp._EPS

typedef unsigned long long Bits;   // one bit per point

// Index of (i, j), i >= j, in a packed lower triangle.
RE_HD constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// torch.clamp's: a NaN passes through.
RE_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
RE_HD float clamp_max(float x, float hi) { return x > hi ? hi : x; }

RE_HD bool has(Bits m, int n) { return (m >> n) & 1ull; }

// The lowest set bit of m != 0.
RE_HD int lowest(Bits m) {
#ifdef __CUDA_ARCH__
  return __ffsll(static_cast<long long>(m)) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

// The six control-point pairs of ops/epnp._PAIR_A / _PAIR_B.
RE_HD constexpr int pair_a(int p) { return p < 3 ? 0 : (p < 5 ? 1 : 2); }
RE_HD constexpr int pair_b(int p) { return p < 3 ? p + 1 : (p == 3 ? 2 : 3); }

// One problem, read once: the points, the keypoints in pixels and
// normalised, the barycentric coordinates of the points in the control
// frame, and the frame's pairwise distances.
struct Problem {
  float P[kMaxPoints][3];
  float px[kMaxPoints][2];
  float uv[kMaxPoints][2];
  float alpha[kMaxPoints][4];
  float ctrl[4][3];
  float coef[3][3];     // the control frame's inverse, adj / det
  float dist_w[6];
  float fx, fy, cx, cy;
  Bits valid;
  int n;
};

// ---------------------------------------------------------------- problem

// normalize_points_2d for point n.
RE_HD void normalize_point(Problem& pr, int n) {
  pr.uv[n][0] = (pr.px[n][0] - pr.cx) / pr.fx;
  pr.uv[n][1] = (pr.px[n][1] - pr.cy) / pr.fy;
}

// epnp_precompute's control frame (_control_points with unit weights,
// _barycentric's Cramer coefficients, _ctrl_distances).
RE_HD void control_frame(Problem& pr) {
  const int n = pr.n;
  float wsum = 0.0f;
  for (int i = 0; i < n; ++i) wsum += 1.0f;
  const float wn = 1.0f / (wsum + kEps);
  float c0[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n; ++i) {
    RE_UNROLL for (int d = 0; d < 3; ++d) c0[d] += wn * pr.P[i][d];
  }
  float ss = 0.0f;
  for (int i = 0; i < n; ++i) {
    RE_UNROLL for (int d = 0; d < 3; ++d) {
      const float c = pr.P[i][d] - c0[d];
      ss += wn * (c * c);
    }
  }
  const float rms = sqrtf(ss / 3.0f + 1e-12f);
  RE_UNROLL for (int d = 0; d < 3; ++d) {
    pr.ctrl[0][d] = c0[d];
    RE_UNROLL for (int k = 0; k < 3; ++k) pr.ctrl[k + 1][d] = c0[d] + (d == k ? rms : 0.0f);
  }
  // core/linalg._solve3_cramer on B[i][k] = ctrl[k + 1][i] - ctrl[0][i]
  float m[3][3];
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    RE_UNROLL for (int k = 0; k < 3; ++k) m[i][k] = pr.ctrl[k + 1][i] - pr.ctrl[0][i];
  }
  const float c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1];
  const float c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2];
  const float c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0];
  const float det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02;
  const float inv_det = 1.0f / det;
  const float adj[3][3] = {
      {c00, m[0][2] * m[2][1] - m[0][1] * m[2][2], m[0][1] * m[1][2] - m[0][2] * m[1][1]},
      {c01, m[0][0] * m[2][2] - m[0][2] * m[2][0], m[0][2] * m[1][0] - m[0][0] * m[1][2]},
      {c02, m[0][1] * m[2][0] - m[0][0] * m[2][1], m[0][0] * m[1][1] - m[0][1] * m[1][0]}};
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    RE_UNROLL for (int j = 0; j < 3; ++j) pr.coef[i][j] = adj[i][j] * inv_det;
  }
  RE_UNROLL for (int p = 0; p < 6; ++p) {
    float s = 0.0f;
    RE_UNROLL for (int d = 0; d < 3; ++d) {
      const float e = pr.ctrl[pair_a(p)][d] - pr.ctrl[pair_b(p)][d];
      s += e * e;
    }
    pr.dist_w[p] = sqrtf(s);
  }
}

// _barycentric for point n.
RE_HD void barycentric(Problem& pr, int n) {
  const float r0 = pr.P[n][0] - pr.ctrl[0][0];
  const float r1 = pr.P[n][1] - pr.ctrl[0][1];
  const float r2 = pr.P[n][2] - pr.ctrl[0][2];
  float beta[3];
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    beta[i] = pr.coef[i][0] * r0 + pr.coef[i][1] * r1 + pr.coef[i][2] * r2;
  }
  pr.alpha[n][0] = 1.0f - (beta[0] + beta[1] + beta[2]);
  pr.alpha[n][1] = beta[0];
  pr.alpha[n][2] = beta[1];
  pr.alpha[n][3] = beta[2];
}

// --------------------------------------------------------- linear algebra

// core/linalg.cholesky_small in place on a packed lower triangle.
template <int M>
RE_HD void cholesky(float* a) {
  RE_UNROLL for (int j = 0; j < M; ++j) {
    float s = a[tri(j, j)];
    RE_UNROLL for (int k = 0; k < j; ++k) s = s - a[tri(j, k)] * a[tri(j, k)];
    const float d = sqrtf(clamp_min(s, 1e-25f));
    a[tri(j, j)] = d;
    const float r = 1.0f / d;
    RE_UNROLL for (int i = j + 1; i < M; ++i) {
      float si = a[tri(i, j)];
      RE_UNROLL for (int k = 0; k < j; ++k) si = si - a[tri(i, k)] * a[tri(j, k)];
      a[tri(i, j)] = si * r;
    }
  }
}

// core/linalg.cho_solve_small for one right-hand side, in place.
template <int M>
RE_HD void cho_solve(const float* L, float* b) {
  RE_UNROLL for (int i = 0; i < M; ++i) {
    float s = b[i];
    RE_UNROLL for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * b[k];
    b[i] = s / L[tri(i, i)];
  }
  RE_UNROLL for (int i = M - 1; i >= 0; --i) {
    float s = b[i];
    RE_UNROLL for (int k = i + 1; k < M; ++k) s = s - L[tri(k, i)] * b[k];
    b[i] = s / L[tri(i, i)];
  }
}

// core/linalg.solve_psd: a (packed, destroyed) x = b, b replaced by x.
template <int M>
RE_HD void solve_psd(float* a, float* b) {
  cholesky<M>(a);
  cho_solve<M>(a, b);
}

// Add point (alpha, u, v) of weight w to the packed 12x12 M^T M: the
// entries of epnp_precompute's G, where a row's zero entries give zero.
RE_HD void add_point_mtm(float* m, const float* al, float u, float v, float w) {
  float ru[12], rv[12];
  RE_UNROLL for (int k = 0; k < 4; ++k) {
    ru[3 * k] = al[k];
    ru[3 * k + 1] = 0.0f;
    ru[3 * k + 2] = -al[k] * u;
    rv[3 * k] = 0.0f;
    rv[3 * k + 1] = al[k];
    rv[3 * k + 2] = -al[k] * v;
  }
  RE_UNROLL for (int i = 0; i < 12; ++i) {
    RE_UNROLL for (int j = 0; j <= i; ++j) {
      const int ti = i % 3, tj = j % 3;
      if ((ti == 0 && tj == 1) || (ti == 1 && tj == 0)) continue;   // always 0
      float g;
      if (ti == 2 && tj == 2) {
        g = ru[i] * ru[j] + rv[i] * rv[j];
      } else if (ti == 1 || tj == 1) {
        g = rv[i] * rv[j];
      } else {
        g = ru[i] * ru[j];
      }
      m[tri(i, j)] += w * g;
    }
  }
}

// Entry e of the packed M^T M over the points of weight w[n] != 0.
RE_HD float mtm_entry(const Problem& pr, const float* w, int e) {
  int i = 0;
  while (tri(i + 1, 0) <= e) ++i;
  const int j = e - tri(i, 0);
  const int ti = i % 3, tj = j % 3, ai = i / 3, aj = j / 3;
  float acc = 0.0f;
  if ((ti == 0 && tj == 1) || (ti == 1 && tj == 0)) return acc;
  for (int n = 0; n < pr.n; ++n) {
    if (w[n] == 0.0f) continue;
    const float* al = pr.alpha[n];
    const float u = pr.uv[n][0], v = pr.uv[n][1];
    const float rui = ti == 0 ? al[ai] : (ti == 1 ? 0.0f : -al[ai] * u);
    const float ruj = tj == 0 ? al[aj] : (tj == 1 ? 0.0f : -al[aj] * u);
    const float rvi = ti == 1 ? al[ai] : (ti == 0 ? 0.0f : -al[ai] * v);
    const float rvj = tj == 1 ? al[aj] : (tj == 0 ? 0.0f : -al[aj] * v);
    float g;
    if (ti == 2 && tj == 2) {
      g = rui * ruj + rvi * rvj;
    } else if (ti == 1 || tj == 1) {
      g = rvi * rvj;
    } else {
      g = rui * ruj;
    }
    acc += w[n] * g;
  }
  return acc;
}

// ops/epnp._gram_schmidt on the KV columns of X (12 x KV, row-major).
template <int KV>
RE_HD void gram_schmidt(float (*X)[KV]) {
  RE_UNROLL for (int j = 0; j < KV; ++j) {
    float v[12];
    RE_UNROLL for (int i = 0; i < 12; ++i) v[i] = X[i][j];
    RE_UNROLL for (int c = 0; c < j; ++c) {
      float dot = 0.0f;
      RE_UNROLL for (int i = 0; i < 12; ++i) dot += v[i] * X[i][c];
      RE_UNROLL for (int i = 0; i < 12; ++i) v[i] = v[i] - dot * X[i][c];
    }
    float ss = 0.0f;
    RE_UNROLL for (int i = 0; i < 12; ++i) ss += v[i] * v[i];
    const float den = sqrtf(ss) + 1e-20f;
    RE_UNROLL for (int i = 0; i < 12; ++i) X[i][j] = v[i] / den;
  }
}

// ops/epnp.smallest_eigvecs: ridge-shifted Cholesky of the packed 12x12
// a (destroyed), then 4 inverse iterations from the start basis (12 x KV,
// row-major), each followed by Gram-Schmidt.
template <int KV>
RE_HD void smallest_eigvecs(float* a, const float* basis, float (*X)[KV]) {
  float tr = 0.0f;
  RE_UNROLL for (int i = 0; i < 12; ++i) tr += a[tri(i, i)];
  const float ridge = 1e-6f * tr / 12.0f + 1e-12f;
  RE_UNROLL for (int i = 0; i < 12; ++i) a[tri(i, i)] += ridge;
  cholesky<12>(a);
  RE_UNROLL for (int i = 0; i < 12; ++i) {
    RE_UNROLL for (int k = 0; k < KV; ++k) X[i][k] = basis[i * KV + k];
  }
  RE_ROLLED for (int it = 0; it < 4; ++it) {
    RE_ROLLED for (int k = 0; k < KV; ++k) {
      float col[12];
      RE_UNROLL for (int i = 0; i < 12; ++i) col[i] = X[i][k];
      cho_solve<12>(a, col);
      RE_UNROLL for (int i = 0; i < 12; ++i) X[i][k] = col[i];
    }
    gram_schmidt<KV>(X);
  }
}

// epnp_reconstruct's closed-form beta1 from the first null vector.
RE_HD float beta1(const float* v0, const float* dist_w) {
  float num = 0.0f, den = 0.0f;
  RE_UNROLL for (int p = 0; p < 6; ++p) {
    float s = 0.0f;
    RE_UNROLL for (int d = 0; d < 3; ++d) {
      const float e = v0[3 * pair_a(p) + d] - v0[3 * pair_b(p) + d];
      s += e * e;
    }
    const float dc = sqrtf(s);
    num += dc * dist_w[p];
    den += dc * dc;
  }
  return num / (den + kEps);
}

// ------------------------------------------------------------------ betas

// ops/epnp._pair_diffs: Vd[k][p][d] for the 4 null vectors V[k].
RE_HD void pair_diffs(const float (*V)[12], float (*Vd)[6][3]) {
  RE_UNROLL for (int k = 0; k < 4; ++k) {
    RE_UNROLL for (int p = 0; p < 6; ++p) {
      RE_UNROLL for (int d = 0; d < 3; ++d) {
        Vd[k][p][d] = V[k][3 * pair_a(p) + d] - V[k][3 * pair_b(p) + d];
      }
    }
  }
}

// _beta_seeds's least squares: cols (6 x KC) x = rho, ridge 1e-7 trace.
template <int KC>
RE_HD void lstsq(const float (*cols)[KC], const float* rho, float* x) {
  float a[KC * (KC + 1) / 2];
  RE_UNROLL for (int i = 0; i < KC; ++i) {
    RE_UNROLL for (int j = 0; j <= i; ++j) {
      float s = 0.0f;
      RE_UNROLL for (int p = 0; p < 6; ++p) s += cols[p][i] * cols[p][j];
      a[tri(i, j)] = s;
    }
  }
  float tr = 0.0f;
  RE_UNROLL for (int i = 0; i < KC; ++i) tr += a[tri(i, i)];
  const float ridge = 1e-7f * tr;
  RE_UNROLL for (int i = 0; i < KC; ++i) a[tri(i, i)] += ridge + 1e-12f;
  RE_UNROLL for (int i = 0; i < KC; ++i) {
    float s = 0.0f;
    RE_UNROLL for (int p = 0; p < 6; ++p) s += cols[p][i] * rho[p];
    x[i] = s;
  }
  solve_psd<KC>(a, x);
}

RE_HD float safe_div(float a, float b) { return a / (fabsf(b) < 1e-12f ? 1e-12f : b); }

// ops/epnp._beta_seeds: the closed-form beta1 and the N = 2, 3, 4 seeds.
RE_HD void beta_seeds(float b1, const float (*Vd)[6][3], const float* dist_w,
                      float (*seeds)[4]) {
  float rho[6], d00[6], d01[6], d11[6], d02[6], d03[6], d12[6];
  RE_UNROLL for (int p = 0; p < 6; ++p) {
    rho[p] = dist_w[p] * dist_w[p];
    float s00 = 0.0f, s01 = 0.0f, s11 = 0.0f, s02 = 0.0f, s03 = 0.0f, s12 = 0.0f;
    RE_UNROLL for (int d = 0; d < 3; ++d) {
      s00 += Vd[0][p][d] * Vd[0][p][d];
      s01 += Vd[0][p][d] * Vd[1][p][d];
      s11 += Vd[1][p][d] * Vd[1][p][d];
      s02 += Vd[0][p][d] * Vd[2][p][d];
      s03 += Vd[0][p][d] * Vd[3][p][d];
      s12 += Vd[1][p][d] * Vd[2][p][d];
    }
    d00[p] = s00; d01[p] = s01; d11[p] = s11;
    d02[p] = s02; d03[p] = s03; d12[p] = s12;
  }
  float c3[6][3], c5[6][5], c4[6][4];
  RE_UNROLL for (int p = 0; p < 6; ++p) {
    c3[p][0] = d00[p]; c3[p][1] = 2.0f * d01[p]; c3[p][2] = d11[p];
    c5[p][0] = d00[p]; c5[p][1] = 2.0f * d01[p]; c5[p][2] = d11[p];
    c5[p][3] = 2.0f * d02[p]; c5[p][4] = 2.0f * d12[p];
    c4[p][0] = d00[p]; c4[p][1] = 2.0f * d01[p]; c4[p][2] = 2.0f * d02[p];
    c4[p][3] = 2.0f * d03[p];
  }
  float x2[3], x3[5], x4[4];
  lstsq<3>(c3, rho, x2);
  lstsq<5>(c5, rho, x3);
  lstsq<4>(c4, rho, x4);
  seeds[0][0] = b1; seeds[0][1] = 0.0f; seeds[0][2] = 0.0f; seeds[0][3] = 0.0f;
  const float s2 = x2[1] < 0.0f ? -1.0f : 1.0f;
  seeds[1][0] = sqrtf(fabsf(x2[0]));
  seeds[1][1] = s2 * sqrtf(fabsf(x2[2]));
  seeds[1][2] = 0.0f;
  seeds[1][3] = 0.0f;
  const float b1_3 = sqrtf(fabsf(x3[0]));
  const float s3 = x3[1] < 0.0f ? -1.0f : 1.0f;
  seeds[2][0] = b1_3;
  seeds[2][1] = s3 * sqrtf(fabsf(x3[2]));
  seeds[2][2] = safe_div(x3[3], b1_3);
  seeds[2][3] = 0.0f;
  const float b1_4 = sqrtf(fabsf(x4[0]));
  seeds[3][0] = b1_4;
  seeds[3][1] = safe_div(x4[1], b1_4);
  seeds[3][2] = safe_div(x4[2], b1_4);
  seeds[3][3] = safe_div(x4[3], b1_4);
}

// _refine_betas's cost: camera control-point distances against world's.
RE_HD float beta_cost(const float* b, const float (*Vd)[6][3], const float* dist_w,
                      float (*diff)[3], float* dist, float* r) {
  float cost = 0.0f;
  RE_UNROLL for (int p = 0; p < 6; ++p) {
    float s = 0.0f;
    RE_UNROLL for (int d = 0; d < 3; ++d) {
      float e = 0.0f;
      RE_UNROLL for (int k = 0; k < 4; ++k) e += b[k] * Vd[k][p][d];
      diff[p][d] = e;
      s += e * e;
    }
    dist[p] = sqrtf(s);
    r[p] = dist[p] - dist_w[p];
    cost += r[p] * r[p];
  }
  return cost;
}

// ops/epnp._refine_betas for one seed: 4 Gauss-Newton steps, monotone
// accept.  Returns the final cost; b is replaced.
RE_HD float refine_betas(float* b, const float (*Vd)[6][3], const float* dist_w) {
  float diff[6][3], dist[6], r[6];
  float cost = beta_cost(b, Vd, dist_w, diff, dist, r);
  RE_ROLLED for (int it = 0; it < 4; ++it) {
    beta_cost(b, Vd, dist_w, diff, dist, r);
    float J[6][4];
    RE_UNROLL for (int p = 0; p < 6; ++p) {
      const float den = clamp_min(dist[p], 1e-9f);
      float unit[3];
      RE_UNROLL for (int d = 0; d < 3; ++d) unit[d] = diff[p][d] / den;
      RE_UNROLL for (int k = 0; k < 4; ++k) {
        float s = 0.0f;
        RE_UNROLL for (int d = 0; d < 3; ++d) s += unit[d] * Vd[k][p][d];
        J[p][k] = s;
      }
    }
    float H[10], g[4];
    RE_UNROLL for (int k = 0; k < 4; ++k) {
      RE_UNROLL for (int l = 0; l <= k; ++l) {
        float s = 0.0f;
        RE_UNROLL for (int p = 0; p < 6; ++p) s += J[p][k] * J[p][l];
        H[tri(k, l)] = s;
      }
    }
    float tr = 0.0f;
    RE_UNROLL for (int k = 0; k < 4; ++k) tr += H[tri(k, k)];
    const float ridge = 1e-6f * tr;
    RE_UNROLL for (int k = 0; k < 4; ++k) H[tri(k, k)] += ridge + 1e-9f;
    RE_UNROLL for (int k = 0; k < 4; ++k) {
      float s = 0.0f;
      RE_UNROLL for (int p = 0; p < 6; ++p) s += J[p][k] * r[p];
      g[k] = s;
    }
    solve_psd<4>(H, g);
    float cand[4];
    RE_UNROLL for (int k = 0; k < 4; ++k) cand[k] = b[k] - g[k];
    float d2[6][3], dist2[6], r2[6];
    const float new_cost = beta_cost(cand, Vd, dist_w, d2, dist2, r2);
    if (new_cost < cost) {
      RE_UNROLL for (int k = 0; k < 4; ++k) b[k] = cand[k];
      cost = new_cost;
    }
  }
  return cost;
}

// epnp_reconstruct's control points in the camera frame (4 x 3, row-major
// as V's), from the null vectors X (12 x KV) and the frame's distances:
// beta1 alone (KV = 1), or the best of the four refined seeds (KV = 4).
template <int KV>
RE_HD void camera_controls(const float (*X)[KV], const float* dist_w, float* cc) {
  float V[KV][12];
  RE_UNROLL for (int k = 0; k < KV; ++k) {
    RE_UNROLL for (int i = 0; i < 12; ++i) V[k][i] = X[i][k];
  }
  const float b1 = beta1(V[0], dist_w);
  if constexpr (KV == 1) {
    RE_UNROLL for (int i = 0; i < 12; ++i) cc[i] = b1 * V[0][i];
  } else {
    float Vd[4][6][3];
    pair_diffs(V, Vd);
    float seeds[4][4], cost[4];
    beta_seeds(b1, Vd, dist_w, seeds);
    RE_ROLLED for (int s = 0; s < 4; ++s) cost[s] = refine_betas(seeds[s], Vd, dist_w);
    int best = 0;
    RE_UNROLL for (int s = 1; s < 4; ++s) {
      if (cost[s] < cost[best]) best = s;      // torch.argmin: the first minimum
    }
    float b[4];
    RE_UNROLL for (int k = 0; k < 4; ++k) b[k] = seeds[best][k];
    RE_UNROLL for (int i = 0; i < 12; ++i) {
      float s = 0.0f;
      RE_UNROLL for (int k = 0; k < 4; ++k) s += b[k] * V[k][i];
      cc[i] = s;
    }
  }
}

// A point in the camera frame: sum over the controls of alpha * cc.
RE_HD void camera_point(const float* al, const float* cc, float* pc) {
  RE_UNROLL for (int d = 0; d < 3; ++d) {
    pc[d] = al[0] * cc[d] + al[1] * cc[3 + d] + al[2] * cc[6 + d] + al[3] * cc[9 + d];
  }
}

// --------------------------------------------------------------- rotation

RE_HD float det3(const float* a) {
  return a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6])
         + a[2] * (a[3] * a[7] - a[4] * a[6]);
}

RE_HD float fro(const float* a) {
  float s = 0.0f;
  RE_UNROLL for (int i = 0; i < 9; ++i) s += a[i] * a[i];
  return sqrtf(s);
}

// ops/epnp._inv3, transposed.
RE_HD void inv3_t(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float det = a * A + b * B + c * C;
  const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? (det < 0.0f ? -1e-20f : 1e-20f) : det);
  const float adj[9] = {A, -(b * i - c * h), b * f - c * e,
                        B, a * i - c * g, -(a * f - c * d),
                        C, -(a * h - b * g), a * e - b * d};
  RE_UNROLL for (int r = 0; r < 3; ++r) {
    RE_UNROLL for (int s = 0; s < 3; ++s) out[3 * s + r] = adj[3 * r + s] * inv_det;
  }
}

RE_HD void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

RE_HD float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// core/linalg.smallest_eigvec3 (with eigvals3_sym's trig eigenvalues).
RE_HD void smallest_eigvec3(const float* A, float* out) {
  const float q = (A[0] + A[4] + A[8]) / 3.0f;
  float B[9];
  RE_UNROLL for (int i = 0; i < 9; ++i) B[i] = A[i] - (i % 4 == 0 ? q : 0.0f);
  float ss = 0.0f;
  RE_UNROLL for (int i = 0; i < 9; ++i) ss += B[i] * B[i];
  const float p = sqrtf(clamp_min(ss / 6.0f, 0.0f));
  const float safe_p = clamp_min(p, 1e-30f);
  float Bn[9];
  RE_UNROLL for (int i = 0; i < 9; ++i) Bn[i] = B[i] / safe_p;
  const float r = clamp_max(clamp_min(det3(Bn) / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float lmax = q + 2.0f * p * cosf(phi);
  const float lmin = q + 2.0f * p * cosf(phi + 2.0943951023931953f);
  const float scale = clamp_min(fmaxf(fabsf(lmin), fabsf(lmax)), 1e-30f);
  float C[9];
  RE_UNROLL for (int i = 0; i < 9; ++i) C[i] = A[i] - (i % 4 == 0 ? lmin : 0.0f);
  const float* r0 = C;
  const float* r1 = C + 3;
  const float* r2 = C + 6;
  float c01[3], c02[3], c12[3];
  cross(r0, r1, c01);
  cross(r0, r2, c02);
  cross(r1, r2, c12);
  const float n01 = dot3(c01, c01), n02 = dot3(c02, c02), n12 = dot3(c12, c12);
  const float* best = n02 > n01 ? c02 : c01;
  float bestn = fmaxf(n01, n02);
  best = n12 > bestn ? c12 : best;
  bestn = fmaxf(bestn, n12);
  const float rn0 = dot3(r0, r0), rn1 = dot3(r1, r1), rn2 = dot3(r2, r2);
  const float* u = rn1 > rn0 ? r1 : r0;
  float un = fmaxf(rn0, rn1);
  u = rn2 > un ? r2 : u;
  un = fmaxf(un, rn2);
  const float ax = fabsf(u[0]);
  const float axis[3] = {ax * ax < 0.8f * un ? 1.0f : 0.0f, ax * ax < 0.8f * un ? 0.0f : 1.0f, 0.0f};
  float plane[3];
  cross(u, axis, plane);
  const float ct = 1e-5f * scale * scale;
  const float rt = 1e-5f * scale;
  float v[3];
  if (bestn > ct * ct) {
    v[0] = best[0]; v[1] = best[1]; v[2] = best[2];
  } else if (un > rt * rt) {
    v[0] = plane[0]; v[1] = plane[1]; v[2] = plane[2];
  } else {
    v[0] = 1.0f; v[1] = 0.0f; v[2] = 0.0f;
  }
  const float nv = clamp_min(sqrtf(dot3(v, v)), 1e-30f);
  RE_UNROLL for (int d = 0; d < 3; ++d) out[d] = v[d] / nv;
}

// ops/epnp.polar_rotation: 6 scaled Newton polar steps, then the Kabsch
// reflection for det < 0.
RE_HD void polar_rotation(const float* M, float* X) {
  const float det = det3(M);
  const float sc = clamp_min(fro(M) / 1.7320508075688772f, 1e-12f);
  RE_UNROLL for (int i = 0; i < 9; ++i) X[i] = M[i] / sc;
  RE_ROLLED for (int it = 0; it < 6; ++it) {
    float Xi[9];
    inv3_t(X, Xi);
    const float nx = fro(X);
    const float ni = fro(Xi);
    const float g = sqrtf(clamp_min(ni / clamp_min(nx, 1e-12f), 1e-12f));
    RE_UNROLL for (int i = 0; i < 9; ++i) X[i] = 0.5f * (g * X[i] + Xi[i] / g);
  }
  if (det < 0.0f) {
    float MtM[9];
    RE_UNROLL for (int i = 0; i < 3; ++i) {
      RE_UNROLL for (int k = 0; k < 3; ++k) {
        MtM[3 * i + k] = M[i] * M[k] + M[3 + i] * M[3 + k] + M[6 + i] * M[6 + k];
      }
    }
    float v[3];
    smallest_eigvec3(MtM, v);
    float refl[9];
    RE_UNROLL for (int i = 0; i < 3; ++i) {
      RE_UNROLL for (int j = 0; j < 3; ++j) refl[3 * i + j] = (i == j ? 1.0f : 0.0f) - 2.0f * v[i] * v[j];
    }
    float Y[9];
    RE_UNROLL for (int i = 0; i < 3; ++i) {
      RE_UNROLL for (int j = 0; j < 3; ++j) {
        Y[3 * i + j] = X[3 * i] * refl[j] + X[3 * i + 1] * refl[3 + j] + X[3 * i + 2] * refl[6 + j];
      }
    }
    RE_UNROLL for (int i = 0; i < 9; ++i) X[i] = Y[i];
  }
}

// ops/epnp.weighted_kabsch of the model points onto dst (N x 3), then
// epnp_from_mask's weighted residual.  Returns the residual.
RE_HD float kabsch_fit(const Problem& pr, const float* w, const float (*dst)[3],
                       float* R, float* t) {
  float wsum = 0.0f;
  for (int n = 0; n < pr.n; ++n) wsum += w[n];
  const float den = wsum + kEps;
  float sc[3] = {0.0f, 0.0f, 0.0f}, dc[3] = {0.0f, 0.0f, 0.0f};
  for (int n = 0; n < pr.n; ++n) {
    if (w[n] == 0.0f) continue;
    const float wn = w[n] / den;
    RE_UNROLL for (int d = 0; d < 3; ++d) {
      sc[d] += wn * pr.P[n][d];
      dc[d] += wn * dst[n][d];
    }
  }
  float cov[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < pr.n; ++n) {
    if (w[n] == 0.0f) continue;
    const float wn = w[n] / den;
    RE_UNROLL for (int i = 0; i < 3; ++i) {
      const float wd = wn * (dst[n][i] - dc[i]);
      RE_UNROLL for (int j = 0; j < 3; ++j) cov[3 * i + j] += wd * (pr.P[n][j] - sc[j]);
    }
  }
  polar_rotation(cov, R);
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    t[i] = dc[i] - (R[3 * i] * sc[0] + R[3 * i + 1] * sc[1] + R[3 * i + 2] * sc[2]);
  }
  float res = 0.0f;
  for (int n = 0; n < pr.n; ++n) {
    if (w[n] == 0.0f) continue;
    float s = 0.0f;
    RE_UNROLL for (int i = 0; i < 3; ++i) {
      const float pred = (R[3 * i] * pr.P[n][0] + R[3 * i + 1] * pr.P[n][1]
                          + R[3 * i + 2] * pr.P[n][2]) + t[i];
      const float e = pred - dst[n][i];
      s += e * e;
    }
    res += w[n] * s;
  }
  return res;
}

// ------------------------------------------------------------- hypotheses

// epnp_reconstruct of the points in `sel` (weights `mask`, or 1): the
// camera-frame controls cc (4 x 3) and the sign that makes the weighted
// mean depth positive.
template <int KV>
RE_HD float reconstruct(const Problem& pr, Bits sel, const float* mask, const float* basis,
                        float* cc) {
  float m[78];
  RE_UNROLL for (int e = 0; e < 78; ++e) m[e] = 0.0f;
  for (Bits s = sel; s != 0; s &= s - 1) {
    const int n = lowest(s);
    add_point_mtm(m, pr.alpha[n], pr.uv[n][0], pr.uv[n][1], mask ? mask[n] : 1.0f);
  }
  float X[12][KV];
  smallest_eigvecs<KV>(m, basis, X);
  camera_controls<KV>(X, pr.dist_w, cc);
  float num = 0.0f, wsum = 0.0f;
  for (Bits s = sel; s != 0; s &= s - 1) {
    const int n = lowest(s);
    const float w = mask ? mask[n] : 1.0f;
    float pc[3];
    camera_point(pr.alpha[n], cc, pc);
    num += w * pc[2];
    wsum += w;
  }
  return num / (wsum + kEps) < 0.0f ? -1.0f : 1.0f;
}

// One hypothesis of ransac_epnp: its sample (the Gumbel top-`sample` of
// the valid points from `unif`, or the weights `mask` when given), EPnP
// on it (beta refinement when `refine`), its inliers and score.
template <int KV>
RE_HD void hypothesis(const Problem& pr, const float* mask, const float* unif, int sample,
                      const float* basis, float thr, float score_div, float* score,
                      Bits* inliers) {
  const int N = pr.n;
  Bits sel = 0;
  if (mask != nullptr) {
    for (int n = 0; n < N; ++n) {
      if (mask[n] != 0.0f) sel |= 1ull << n;
    }
  } else {
    // torch.topk of the Gumbel keys, -inf off the valid set; among equal
    // keys the lower index first
    float g[kMaxPoints];
    for (int n = 0; n < N; ++n) {
      const float u = clamp_min(unif[n], 1.17549435e-38f);
      g[n] = has(pr.valid, n) ? -logf(-logf(u)) : -INFINITY;
    }
    for (int j = 0; j < sample; ++j) {
      int pick = -1;
      float pg = 0.0f;
      for (int n = 0; n < N; ++n) {
        if (!has(sel, n) && (pick < 0 || g[n] > pg)) {
          pick = n;
          pg = g[n];
        }
      }
      sel |= 1ull << pick;
    }
  }
  float cc[12];
  const float sign = reconstruct<KV>(pr, sel, mask, basis, cc);
  int n_inl = 0;
  float err_sum = 0.0f;
  Bits inl = 0;
  for (int n = 0; n < N; ++n) {
    float pc[3];
    camera_point(pr.alpha[n], cc, pc);
    const float z0 = pc[2] * sign;
    const float z = fabsf(z0) < 1e-6f ? 1e-6f : z0;
    const float dx = ((pc[0] * sign) / z - pr.uv[n][0]) * pr.fx;
    const float dy = ((pc[1] * sign) / z - pr.uv[n][1]) * pr.fy;
    const float err = sqrtf(dx * dx + dy * dy);
    if (err < thr && has(pr.valid, n)) {
      inl |= 1ull << n;
      ++n_inl;
      err_sum += err;
    }
  }
  const float mean_err = err_sum / static_cast<float>(n_inl > 1 ? n_inl : 1);
  *score = static_cast<float>(n_inl) - mean_err / score_div;
  *inliers = inl;
}

// torch.argmax's order: the larger score, a NaN above all, and the lower
// index among equals.
RE_HD bool better(float s, int h, float bs, int bh) {
  const bool sn = s != s, bn = bs != bs;
  if (sn || bn) return sn && (!bn || h < bh);
  return s > bs || (s == bs && h < bh);
}

// ------------------------------------------------------------------ refit

// ops/epnp.mirror_cloud: the N points of cam reflected across the plane
// through their weighted centroid perpendicular to the line of sight, into
// mir.  wsum: the sum of the weights w.
RE_HD void mirror_cloud(const float* w, int N, float wsum, const float (*cam)[3],
                        float (*mir)[3]) {
  const float den = wsum + kEps;
  float c[3] = {0.0f, 0.0f, 0.0f};
  for (int n = 0; n < N; ++n) {
    if (w[n] == 0.0f) continue;
    const float wn = w[n] / den;
    RE_UNROLL for (int d = 0; d < 3; ++d) c[d] += wn * cam[n][d];
  }
  const float cn = clamp_min(sqrtf(dot3(c, c)), kEps);
  const float nv[3] = {c[0] / cn, c[1] / cn, c[2] / cn};
  for (int n = 0; n < N; ++n) {
    const float dd = (cam[n][0] - c[0]) * nv[0] + (cam[n][1] - c[1]) * nv[1]
                     + (cam[n][2] - c[2]) * nv[2];
    RE_UNROLL for (int d = 0; d < 3; ++d) mir[n][d] = cam[n][d] - 2.0f * dd * nv[d];
  }
}

// epnp_from_mask with beta refinement on the weights w, from the packed
// M^T M over them (destroyed): the reconstruction and its mirror, each
// aligned by Kabsch, the lower residual kept.  cam and mir: scratch of
// N x 3.
RE_HD void refit(const Problem& pr, const float* w, float* m, const float* basis4,
                 float (*cam)[3], float (*mir)[3], float* R, float* t) {
  float X[12][4];
  smallest_eigvecs<4>(m, basis4, X);
  float cc[12];
  camera_controls<4>(X, pr.dist_w, cc);
  const int N = pr.n;
  float num = 0.0f, wsum = 0.0f;
  for (int n = 0; n < N; ++n) {
    camera_point(pr.alpha[n], cc, cam[n]);
    if (w[n] == 0.0f) continue;
    num += w[n] * cam[n][2];
    wsum += w[n];
  }
  const float sign = num / (wsum + kEps) < 0.0f ? -1.0f : 1.0f;
  for (int n = 0; n < N; ++n) {
    RE_UNROLL for (int d = 0; d < 3; ++d) cam[n][d] *= sign;
  }
  mirror_cloud(w, N, wsum, cam, mir);
  float Rf[2][9], tf[2][3], e[2];
  RE_ROLLED for (int f = 0; f < 2; ++f) e[f] = kabsch_fit(pr, w, f ? mir : cam, Rf[f], tf[f]);
  const int pick = e[1] < e[0] ? 1 : 0;
  RE_UNROLL for (int i = 0; i < 9; ++i) R[i] = Rf[pick][i];
  RE_UNROLL for (int i = 0; i < 3; ++i) t[i] = tf[pick][i];
}

// --------------------------------------------------------------------- LM

constexpr int kLmTerms = 28;   // H (21, packed), g (6), sum of r^2

RE_HD void transform(const float* R, const float* t, const float* P, float* p) {
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    p[i] = (R[3 * i] * P[0] + R[3 * i + 1] * P[1] + R[3 * i + 2] * P[2]) + t[i];
  }
}

// _lm_refine_batched's residual of point n: r^2 summed.
RE_HD float lm_sq_residual(const Problem& pr, float w, int n, const float* R, const float* t) {
  float p[3];
  transform(R, t, pr.P[n], p);
  const float z = clamp_min(p[2], 1e-6f);
  const float r0 = (p[0] / z - pr.uv[n][0]) * w;
  const float r1 = (p[1] / z - pr.uv[n][1]) * w;
  return r0 * r0 + r1 * r1;
}

// Point n's terms of J^T J, J^T r and r^2 (Jacobian of a left SO(3)
// increment and the translation), added to acc.
RE_HD void lm_point(const Problem& pr, float w, int n, const float* R, const float* t,
                    float* acc) {
  float p[3];
  transform(R, t, pr.P[n], p);
  const float z = clamp_min(p[2], 1e-6f);
  const float r[2] = {(p[0] / z - pr.uv[n][0]) * w, (p[1] / z - pr.uv[n][1]) * w};
  const float iz = 1.0f / z;
  const float A[2][3] = {{iz * w, 0.0f * w, -p[0] * iz * iz * w},
                         {0.0f * w, iz * w, -p[1] * iz * iz * w}};
  const float q[3] = {p[0] - t[0], p[1] - t[1], p[2] - t[2]};
  const float S[3][3] = {{0.0f, q[2], -q[1]}, {-q[2], 0.0f, q[0]}, {q[1], -q[0], 0.0f}};
  float J[2][6];
  RE_UNROLL for (int i = 0; i < 2; ++i) {
    RE_UNROLL for (int c = 0; c < 3; ++c) {
      J[i][c] = A[i][0] * S[0][c] + A[i][1] * S[1][c] + A[i][2] * S[2][c];
      J[i][3 + c] = A[i][c];
    }
  }
  RE_UNROLL for (int k = 0; k < 6; ++k) {
    RE_UNROLL for (int l = 0; l <= k; ++l) acc[tri(k, l)] += J[0][k] * J[0][l] + J[1][k] * J[1][l];
    acc[21 + k] += J[0][k] * r[0] + J[1][k] * r[1];
  }
  acc[27] += r[0] * r[0] + r[1] * r[1];
}

// core/camera.rodrigues.
RE_HD void rodrigues(const float* s, float* R) {
  const float theta = sqrtf(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
  const bool small = theta < 1e-8f;
  const float safe = small ? 1.0f : theta;
  const float k[3] = {s[0] / safe, s[1] / safe, s[2] / safe};
  const float K[9] = {0.0f, -k[2], k[1], k[2], 0.0f, -k[0], -k[1], k[0], 0.0f};
  if (small) {
    RE_UNROLL for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0 ? 1.0f : 0.0f) + theta * K[i];
    return;
  }
  const float sn = sinf(theta), cs = 1.0f - cosf(theta);
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    RE_UNROLL for (int j = 0; j < 3; ++j) {
      const float kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      R[3 * i + j] = ((i == j ? 1.0f : 0.0f) + sn * K[3 * i + j]) + cs * kk;
    }
  }
}

// One damped Gauss-Newton candidate from the summed terms: solve
// (H + lam diag(max(H_kk, 1e-10))) x = g, step -x, R <- exp(step) R.
RE_HD void lm_candidate(const float* acc, float lam, const float* R, const float* t,
                        float* Rn, float* tn) {
  float H[21], x[6];
  RE_UNROLL for (int i = 0; i < 21; ++i) H[i] = acc[i];
  RE_UNROLL for (int k = 0; k < 6; ++k) {
    H[tri(k, k)] = acc[tri(k, k)] + lam * clamp_min(acc[tri(k, k)], 1e-10f);
    x[k] = acc[21 + k];
  }
  solve_psd<6>(H, x);
  const float step[3] = {-x[0], -x[1], -x[2]};
  float D[9];
  rodrigues(step, D);
  RE_UNROLL for (int i = 0; i < 3; ++i) {
    RE_UNROLL for (int j = 0; j < 3; ++j) {
      Rn[3 * i + j] = D[3 * i] * R[j] + D[3 * i + 1] * R[3 + j] + D[3 * i + 2] * R[6 + j];
    }
    tn[i] = t[i] + -x[3 + i];
  }
}

// The LM's accept rule and damping schedule.  Returns whether it took
// the candidate.
RE_HD bool lm_accept(float sq, float new_sq, float* lam) {
  const bool ok = 0.5f * new_sq < 0.5f * sq;
  *lam = ok ? clamp_min(*lam / 3.0f, 1e-10f) : clamp_max(*lam * 4.0f, 1e8f);
  return ok;
}

// The sum of a value over the lanes that share one LM: a butterfly over
// the warp on the card (every lane ends with the same bits); on the host,
// where one lane owns every point, the value itself.
struct GroupSum {
  RE_HD float operator()(float v) const {
#ifdef __CUDA_ARCH__
    RE_UNROLL for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
#endif
    return v;
  }
};

// _lm_refine_batched from (R, t) on the weights w: `iters` damped
// Gauss-Newton steps, R and t replaced.  The lanes of a group own the
// points lane, lane + stride, ...; `sum` adds a value over the group
// (GroupSum), so that every lane takes the same step.  Returns the sum of
// r^2 at the final pose: the final cost is half of it.
template <typename Sum>
RE_HD float lm_refine(const Problem& pr, const float* w, int iters, int lane, int stride,
                      Sum sum, float* R, float* t) {
  const int N = pr.n;
  float lam = 1e-3f;
  RE_ROLLED for (int it = 0; it < iters; ++it) {
    float acc[kLmTerms];
    RE_UNROLL for (int i = 0; i < kLmTerms; ++i) acc[i] = 0.0f;
    for (int n = lane; n < N; n += stride) {
      if (w[n] != 0.0f) lm_point(pr, w[n], n, R, t, acc);
    }
    RE_UNROLL for (int i = 0; i < kLmTerms; ++i) acc[i] = sum(acc[i]);
    float Rn[9], tn[3];
    lm_candidate(acc, lam, R, t, Rn, tn);
    float sq = 0.0f;
    for (int n = lane; n < N; n += stride) {
      if (w[n] != 0.0f) sq += lm_sq_residual(pr, w[n], n, Rn, tn);
    }
    sq = sum(sq);
    if (lm_accept(acc[kLmTerms - 1], sq, &lam)) {
      RE_UNROLL for (int i = 0; i < 9; ++i) R[i] = Rn[i];
      RE_UNROLL for (int i = 0; i < 3; ++i) t[i] = tn[i];
    }
  }
  float sq = 0.0f;
  for (int n = lane; n < N; n += stride) {
    if (w[n] != 0.0f) sq += lm_sq_residual(pr, w[n], n, R, t);
  }
  return sum(sq);
}

// reprojection_errors < thr for point n (core/camera.project_points).
RE_HD bool final_inlier(const Problem& pr, int n, const float* R, const float* t, float thr) {
  float p[3];
  transform(R, t, pr.P[n], p);
  const float x = p[0] / p[2], y = p[1] / p[2];
  const float du = (pr.fx * x + pr.cx) - pr.px[n][0];
  const float dv = (pr.fy * y + pr.cy) - pr.px[n][1];
  return sqrtf(du * du + dv * dv) < thr && has(pr.valid, n);
}

}  // namespace repnp
