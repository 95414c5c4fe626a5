"""A frozen copy, for the benchmark's plain reference, of the port's
ops/epnp.py.
It imports nothing of the port, so a later change to the port's code leaves
it as it is.  The original's first line:

Batched EPnP (Efficient Perspective-n-Point), torch port of the JAX
package's ``ops/epnp.py`` (reference: pnp.py:46-90, cv2 SOLVEPNP_EPNP).

The same weighted, fixed-shape formulation: every solve takes a per-point
weight vector, so RANSAC samples, inlier re-fits and confidence weighting
are weight masks over static (N) arrays.  No eigh/svd: the 12x12 null
space comes from shifted subspace inverse iteration and the 3x3 rotation
fit from Newton polar iteration with a closed-form reflection fix.
Algorithm: Lepetit, Moreno-Noguer, Fua, IJCV 2009.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from h100_bench.reference import linalg
from h100_bench.reference.camera import project_points

_EPS = 1e-9
_PAIR_A = (0, 0, 0, 1, 1, 2)
_PAIR_B = (1, 2, 3, 2, 3, 3)


def normalize_points_2d(points_2d: torch.Tensor, K: torch.Tensor
                        ) -> torch.Tensor:
    """Pixel -> normalized camera-plane coordinates: (u-cx)/fx, (v-cy)/fy."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = (points_2d[..., 0] - cx[..., None]) / fx[..., None]
    y = (points_2d[..., 1] - cy[..., None]) / fy[..., None]
    return torch.stack([x, y], dim=-1)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via adjugate (batched, branch-free)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-20,
                                torch.where(det < 0, -1e-20, 1e-20), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1)], dim=-2)
    return adj * inv_det[..., None, None]


def _fro(M: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((M * M).sum((-2, -1), keepdim=True))


def polar_rotation(M: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Nearest PROPER rotation to a batched 3x3 matrix: scaled Newton polar
    iteration (Higham), then, for det<0 inputs, the Kabsch reflection along
    the least principal direction of M (SVD's ``U diag(1,1,-1) V^T``)."""
    det = linalg._det3(M)
    X = M / torch.clamp(_fro(M) / np.sqrt(3.0), min=1e-12)
    for _ in range(iters):
        Xi_t = _inv3(X).transpose(-1, -2)
        nx = _fro(X)
        ni = _fro(Xi_t)
        g = torch.sqrt(torch.clamp(ni / torch.clamp(nx, min=1e-12),
                                   min=1e-12))
        X = 0.5 * (g * X + Xi_t / g)
    MtM = torch.einsum('...ji,...jk->...ik', M, M)
    v = linalg.smallest_eigvec3(MtM)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    refl = eye - 2.0 * v[..., :, None] * v[..., None, :]
    X_fixed = torch.matmul(X, refl)
    return torch.where((det < 0)[..., None, None], X_fixed, X)


def weighted_kabsch(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment: R, t minimizing sum w ||R src + t - dst||^2.
    src, dst: (..., N, 3); weights: (..., N)."""
    w = weights / (weights.sum(-1, keepdim=True) + _EPS)
    src_c = (w[..., None] * src).sum(-2)
    dst_c = (w[..., None] * dst).sum(-2)
    s = src - src_c[..., None, :]
    d = dst - dst_c[..., None, :]
    cov = torch.einsum('...ni,...nj->...ij', w[..., None] * d, s)
    R = polar_rotation(cov)
    t = dst_c - torch.einsum('...ij,...j->...i', R, src_c)
    return R, t


def _control_points(points_3d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Four control points: weighted centroid + rms-scaled axis-aligned
    frame.  points_3d (..., N, 3); w (..., N) -> (..., 4, 3)."""
    wn = w / (w.sum(-1, keepdim=True) + _EPS)
    c0 = (wn[..., None] * points_3d).sum(-2)
    centered = points_3d - c0[..., None, :]
    rms = torch.sqrt((wn[..., None] * centered ** 2).sum((-2, -1)) / 3.0
                     + 1e-12)
    eye = torch.eye(3, dtype=points_3d.dtype, device=points_3d.device)
    axes = rms[..., None, None] * eye
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes], dim=-2)


def _gram_schmidt(X: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the k columns of (..., 12, k) (modified Gram-Schmidt)."""
    cols = []
    for j in range(X.shape[-1]):
        v = X[..., j]
        for u in cols:
            v = v - (v * u).sum(-1, keepdim=True) * u
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-20)
        cols.append(v)
    return torch.stack(cols, dim=-1)


def _start_basis(m: int, k: int) -> np.ndarray:
    """The reference's fixed full-rank start basis (deterministic)."""
    rng = np.random.default_rng(12345)
    return np.linalg.qr(rng.normal(size=(m, k)))[0]


@lru_cache(maxsize=8)
def _start_basis_tensor(m: int, k: int, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    """:func:`_start_basis` on ``device``, copied once: a copy from host
    memory on every call would make the host wait for the queued kernels
    (the JAX package bakes it into the jitted program)."""
    return torch.as_tensor(_start_basis(m, k), dtype=dtype, device=device)


def smallest_eigvecs(A: torch.Tensor, k: int = 4,
                     iters: int = 4) -> torch.Tensor:
    """The k eigenvectors of smallest eigenvalue of a batched PSD matrix via
    ridge-shifted subspace inverse iteration. A: (..., 12, 12) ->
    (..., 12, k), first column ~ smallest."""
    m = A.shape[-1]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    ridge = (1e-6 * tr / m + 1e-12)[..., None, None]
    L = linalg.cholesky_small(A + ridge * eye)
    X0 = _start_basis_tensor(m, k, A.dtype, A.device)
    X = X0.expand(A.shape[:-2] + (m, k))
    for _ in range(iters):
        X = _gram_schmidt(linalg.cho_solve_small(L, X))
    return X


def _barycentric(points_3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates wrt the 4 control points -> (..., N, 4)."""
    B = (ctrl[..., 1:, :] - ctrl[..., :1, :]).transpose(-1, -2)   # (..., 3, 3)
    rhs = (points_3d - ctrl[..., :1, :]).transpose(-1, -2)        # (..., 3, N)
    beta = linalg.solve(B, rhs).transpose(-1, -2)                 # (..., N, 3)
    alpha0 = 1.0 - beta.sum(-1, keepdim=True)
    return torch.cat([alpha0, beta], dim=-1)


@lru_cache(maxsize=8)
def _pair_index(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:data:`_PAIR_A` and :data:`_PAIR_B` as index tensors on ``device``,
    made once: indexing with the tuples copies them to the device on every
    call, and the copy makes the host wait for the queued kernels."""
    return (torch.tensor(_PAIR_A, device=device),
            torch.tensor(_PAIR_B, device=device))


def _ctrl_distances(ctrl: torch.Tensor) -> torch.Tensor:
    """The 6 pairwise distances between 4 control points -> (..., 6)."""
    a, b = _pair_index(ctrl.device)
    diff = ctrl[..., a, :] - ctrl[..., b, :]
    return torch.linalg.vector_norm(diff, dim=-1)


def _pair_diffs(V: torch.Tensor) -> torch.Tensor:
    Vc = V.reshape(V.shape[:-1] + (4, 3))          # (..., basis, ctrl, xyz)
    a, b = _pair_index(V.device)
    return Vc[..., :, a, :] - Vc[..., :, b, :]     # (..., nb, 6, 3)


def _refine_betas(betas0: torch.Tensor, V: torch.Tensor, dist_w: torch.Tensor,
                  iters: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on the 4 betas matching camera control-point distances
    to world distances, with monotone accept.  betas0 (..., 4); V (..., 4,
    12); dist_w (..., 6).  Returns (betas, final distance cost)."""
    Vd = _pair_diffs(V)                            # (..., 4, 6, 3)

    def cost_of(b):
        diff = torch.einsum('...k,...kpi->...pi', b, Vd)       # (..., 6, 3)
        dist = torch.linalg.vector_norm(diff, dim=-1)
        r = dist - dist_w
        return diff, dist, r, (r * r).sum(-1)

    betas = betas0
    _, _, _, cost = cost_of(betas)
    eye4 = torch.eye(4, dtype=betas0.dtype, device=betas0.device)
    for _ in range(iters):
        diff, dist, r, _ = cost_of(betas)
        unit = diff / torch.clamp(dist, min=1e-9)[..., None]
        J = torch.einsum('...pi,...kpi->...pk', unit, Vd)      # (..., 6, 4)
        H = torch.einsum('...pk,...pl->...kl', J, J)
        # scale-aware ridge: an absolute 1e-9 vanishes under f32 rounding of
        # O(1) entries when few points make the 4x4 system rank-deficient
        ridge = 1e-6 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)[..., None,
                                                                     None]
        H = H + (ridge + 1e-9) * eye4
        g = torch.einsum('...pk,...p->...k', J, r)
        cand = betas - linalg.solve_psd(H, g)
        _, _, _, new_cost = cost_of(cand)
        ok = (new_cost < cost)[..., None]
        betas = torch.where(ok, cand, betas)
        cost = torch.where(ok[..., 0], new_cost, cost)
    return betas, cost


def _beta_seeds(b1: torch.Tensor, V: torch.Tensor,
                dist_w: torch.Tensor) -> torch.Tensor:
    """Candidate beta seeds for the distance Gauss-Newton -> (..., 4, 4):
    the closed-form beta1, then the EPnP paper's N=2/3/4 approximations."""
    Vd = _pair_diffs(V)                                    # (..., 4, 6, 3)
    rho = dist_w * dist_w

    def dot(k, l):
        return (Vd[..., k, :, :] * Vd[..., l, :, :]).sum(-1)

    def lstsq(cols):
        k = cols.shape[-1]
        AtA = torch.einsum('...pi,...pj->...ij', cols, cols)
        ridge = 1e-7 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[
            ..., None, None]
        AtA = AtA + (ridge + 1e-12) * torch.eye(k, dtype=cols.dtype,
                                                device=cols.device)
        Atb = torch.einsum('...pi,...p->...i', cols, rho)
        return linalg.solve_psd(AtA, Atb)

    d00, d01, d11 = dot(0, 0), dot(0, 1), dot(1, 1)
    d02, d03, d12 = dot(0, 2), dot(0, 3), dot(1, 2)

    def sqrt_abs(x):
        return torch.sqrt(x.abs())

    def safe_div(a, b):
        return a / torch.where(b.abs() < 1e-12, 1e-12, b)

    zeros = torch.zeros_like(b1)
    x2 = lstsq(torch.stack([d00, 2 * d01, d11], dim=-1))
    s2 = torch.where(x2[..., 1] < 0, -1.0, 1.0)
    seed2 = torch.stack([sqrt_abs(x2[..., 0]), s2 * sqrt_abs(x2[..., 2]),
                         zeros, zeros], dim=-1)
    x3 = lstsq(torch.stack([d00, 2 * d01, d11, 2 * d02, 2 * d12], dim=-1))
    b1_3 = sqrt_abs(x3[..., 0])
    s3 = torch.where(x3[..., 1] < 0, -1.0, 1.0)
    seed3 = torch.stack([b1_3, s3 * sqrt_abs(x3[..., 2]),
                         safe_div(x3[..., 3], b1_3), zeros], dim=-1)
    x4 = lstsq(torch.stack([d00, 2 * d01, 2 * d02, 2 * d03], dim=-1))
    b1_4 = sqrt_abs(x4[..., 0])
    seed4 = torch.stack([b1_4, safe_div(x4[..., 1], b1_4),
                         safe_div(x4[..., 2], b1_4),
                         safe_div(x4[..., 3], b1_4)], dim=-1)
    seed1 = torch.stack([b1, zeros, zeros, zeros], dim=-1)
    return torch.stack([seed1, seed2, seed3, seed4], dim=-2)


class EpnpShared(NamedTuple):
    """Per-problem precomputation shared by every weight mask/hypothesis."""
    points_3d: torch.Tensor   # (..., N, 3)
    alphas: torch.Tensor      # (..., N, 4)
    G: torch.Tensor           # (..., N, 12, 12)
    dist_w: torch.Tensor      # (..., 6)


def epnp_precompute(points_3d: torch.Tensor, points_2d: torch.Tensor,
                    K: torch.Tensor) -> EpnpShared:
    """Batched over leading dims of points_3d/points_2d."""
    n = points_3d.shape[-2]
    ones = torch.ones(points_3d.shape[:-1], dtype=points_3d.dtype,
                      device=points_3d.device)
    norm_2d = normalize_points_2d(points_2d, K)
    ctrl = _control_points(points_3d, ones)
    alphas = _barycentric(points_3d, ctrl)
    u = norm_2d[..., 0]
    v = norm_2d[..., 1]
    zeros = torch.zeros_like(alphas)
    lead = points_3d.shape[:-2]
    rows_u = torch.stack([alphas, zeros, -alphas * u[..., None]], dim=-1
                         ).reshape(lead + (n, 12))
    rows_v = torch.stack([zeros, alphas, -alphas * v[..., None]], dim=-1
                         ).reshape(lead + (n, 12))
    G = (rows_u[..., :, None] * rows_u[..., None, :]
         + rows_v[..., :, None] * rows_v[..., None, :])
    return EpnpShared(points_3d=points_3d, alphas=alphas, G=G,
                      dist_w=_ctrl_distances(ctrl))


def epnp_reconstruct(shared: EpnpShared, w: torch.Tensor,
                     refine_betas: bool = True) -> torch.Tensor:
    """Camera-frame point reconstruction for weight mask(s) -> (..., N, 3)
    (EPnP up to, not including, the rigid alignment)."""
    batch = torch.broadcast_shapes(w.shape[:-1], shared.G.shape[:-3])
    MtM = torch.einsum('...n,...nij->...ij', w, shared.G).expand(
        batch + (12, 12))
    nv = 4 if refine_betas else 1
    V = smallest_eigvecs(MtM, k=nv).transpose(-1, -2)      # (..., nv, 12)

    dist_w = shared.dist_w.expand(batch + (6,))
    ctrl1 = V[..., 0, :].reshape(batch + (4, 3))
    dist_c = _ctrl_distances(ctrl1)
    b1 = ((dist_c * dist_w).sum(-1)
          / ((dist_c * dist_c).sum(-1) + _EPS))
    if refine_betas:
        seeds = _beta_seeds(b1, V, dist_w)                  # (..., 4, 4)
        cand, cost = _refine_betas(seeds, V[..., None, :, :],
                                   dist_w[..., None, :])
        best = torch.argmin(cost, dim=-1)
        betas = torch.gather(
            cand, -2, best[..., None, None].expand(batch + (1, 4)))[..., 0, :]
    else:
        betas = b1[..., None]

    ctrl_cam = torch.einsum('...k,...kj->...j', betas, V).reshape(
        batch + (4, 3))
    pts_cam = torch.einsum('...na,...ai->...ni', shared.alphas, ctrl_cam)

    # resolve the global sign: weighted mean depth must be positive
    depth = ((w * pts_cam[..., 2]).sum(-1) / (w.sum(-1) + _EPS))
    return pts_cam * torch.where(depth < 0, -1.0, 1.0)[..., None, None]


def mirror_cloud(pts_cam: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weak-perspective mirror of a camera-frame cloud: reflection across
    the plane through the weighted centroid perpendicular to the line of
    sight (the two-fold bas-relief ambiguity)."""
    wn = w / (w.sum(-1, keepdim=True) + _EPS)
    c = (wn[..., None] * pts_cam).sum(-2)                       # (..., 3)
    n = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True),
                        min=_EPS)
    d = torch.einsum('...ni,...i->...n', pts_cam - c[..., None, :], n)
    return pts_cam - 2.0 * d[..., None] * n[..., None, :]


def epnp_from_mask(shared: EpnpShared, w: torch.Tensor,
                   refine_betas: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve EPnP for weight mask(s) using the shared precomputation;
    returns (R, t).  The rigid alignment tries the reconstruction and its
    weak-perspective mirror and keeps the lower weighted Procrustes
    residual (a mirrored reconstruction satisfies the distance constraints
    exactly, and no proper rotation aligns it)."""
    pts_cam = epnp_reconstruct(shared, w, refine_betas=refine_betas)
    batch = pts_cam.shape[:-2]
    p3 = shared.points_3d.expand(batch + shared.points_3d.shape[-2:])
    wb = w.expand(batch + (w.shape[-1],))
    pm = mirror_cloud(pts_cam, wb)

    def fit(target):
        R, t = weighted_kabsch(p3, target, wb)
        pred = torch.einsum('...ij,...nj->...ni', R, p3) + t[..., None, :]
        res = (wb * ((pred - target) ** 2).sum(-1)).sum(-1)
        return R, t, res

    R1, t1, e1 = fit(pts_cam)
    R2, t2, e2 = fit(pm)
    pick = (e2 < e1)[..., None]
    return (torch.where(pick[..., None], R2, R1),
            torch.where(pick, t2, t1))


def reprojection_errors(points_3d: torch.Tensor, points_2d: torch.Tensor,
                        R: torch.Tensor, t: torch.Tensor,
                        K: torch.Tensor) -> torch.Tensor:
    """Per-point pixel reprojection error -> (..., N)."""
    proj = project_points(points_3d, R, t, K)
    return torch.linalg.vector_norm(proj - points_2d, dim=-1)


def epnp_single(points_3d: torch.Tensor, points_2d: torch.Tensor,
                K: torch.Tensor, weights: torch.Tensor | None = None,
                refine_betas: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """EPnP for one problem: points_3d (N, 3), points_2d (N, 2) pixels,
    K (3, 3), weights (N,) nonnegative (0 excludes a point).  Returns
    (R (3, 3), t (3,)) with x_cam = R x_world + t."""
    return epnp(points_3d, points_2d, K, weights, refine_betas)


def epnp(points_3d: torch.Tensor, points_2d: torch.Tensor, K: torch.Tensor,
         weights: torch.Tensor | None = None, refine_betas: bool = True
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched EPnP over any leading dims: points_3d (..., N, 3),
    points_2d (..., N, 2), K (3, 3) or broadcast, weights (..., N) or
    None (all ones).  Returns (R (..., 3, 3), t (..., 3))."""
    if weights is None:
        weights = torch.ones(points_3d.shape[:-1], dtype=points_3d.dtype,
                             device=points_3d.device)
    shared = epnp_precompute(points_3d, points_2d, K)
    return epnp_from_mask(shared, weights, refine_betas=refine_betas)
