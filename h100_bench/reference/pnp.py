"""A frozen copy, for the benchmark's plain reference, of the port's
ops/pnp.py (its serving subset).
It imports nothing of the port, so a later change to the port's code leaves
it as it is.  The original's first line:

RANSAC-EPnP initialization + weighted Levenberg-Marquardt refinement
(torch port of the serving subset of the JAX package's ``ops/pnp.py``).

* :func:`ransac_epnp` replaces ``cv2.solvePnPRansac(reprojectionError=5,
  SOLVEPNP_EPNP)`` (reference: pnp.py:68-73) with a fixed sweep of
  hypotheses, each a weight mask, all solved as one batch.
* :func:`lm_refine` replaces the Ceres ``cpnp.cpnp_m`` refinement: a
  fixed-iteration damped Gauss-Newton on a left SO(3) increment plus
  translation, minimizing confidence-weighted reprojection residuals.

Everything is static-shape and branch-free (accept/reject via ``where``),
f32 in K-normalized coordinates, with Python loops of fixed length where
the reference uses ``lax.scan``.  Nothing on the path reads a value back
to the host.

* :func:`uncertainty_pnp` replaces the Ceres ``uncertainty_pnp`` of the
  LINEMOD/PVNet path (lib/utils/extend_utils/src/uncertainty_pnp.cpp:7-92):
  RANSAC-EPnP, then LM on the reprojection residual weighted per point by
  the inverse square root of its voting covariance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from h100_bench.reference import linalg
from h100_bench.reference.camera import (
    rodrigues,
    rotmat_to_rvec,
)
from h100_bench.reference.epnp import (
    EpnpShared,
    epnp_from_mask,
    epnp_precompute,
    epnp_reconstruct,
    mirror_cloud,
    normalize_points_2d,
    reprojection_errors,
    weighted_kabsch,
)


class PnPResult(NamedTuple):
    R: torch.Tensor          # (..., 3, 3)
    t: torch.Tensor          # (..., 3)
    inliers: torch.Tensor    # (..., N) bool
    cost: torch.Tensor       # (...,) final weighted cost


def _proj_cost(R, t, points_3d, norm_2d, w):
    """(residuals (..., N, 2), cost (...,)) in normalized coordinates."""
    p = torch.einsum('...ij,...nj->...ni', R, points_3d) + t[..., None, :]
    z = torch.clamp(p[..., 2], min=1e-6)
    proj = p[..., :2] / z[..., None]
    r = (proj - norm_2d) * w[..., None]
    return r, 0.5 * (r * r).sum((-2, -1))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def _lm_refine_batched(points_3d: torch.Tensor, points_2d: torch.Tensor,
                       weights: torch.Tensor, K: torch.Tensor,
                       R0: torch.Tensor, t0: torch.Tensor, iters: int = 20
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton over any leading batch dims, analytic Jacobian
    (``R <- exp(delta) R``, ``t <- t + dt``; ``dp/ddelta = -[R x]_x``), one
    batched 6x6 Cholesky solve per iteration.  Returns (R, t, cost)."""
    norm_2d = normalize_points_2d(points_2d, K)
    eye6 = torch.eye(6, dtype=points_3d.dtype, device=points_3d.device)
    # the batch covers BOTH the problem arrays and the pose init:
    # lm_refine_dual refines (2, ...) candidates against shared problems
    batch = torch.broadcast_shapes(points_3d.shape[:-2], R0.shape[:-2])
    R = R0.expand(batch + (3, 3))
    t = t0.expand(batch + (3,))
    lam = torch.full(batch, 1e-3, dtype=points_3d.dtype,
                     device=points_3d.device)
    for _ in range(iters):
        p = torch.einsum('...ij,...nj->...ni', R, points_3d) + t[..., None, :]
        z = torch.clamp(p[..., 2], min=1e-6)
        proj = p[..., :2] / z[..., None]
        r = (proj - norm_2d) * weights[..., None]          # (..., N, 2)
        cost = 0.5 * (r * r).sum((-2, -1))

        iz = 1.0 / z
        zero = torch.zeros_like(iz)
        A = torch.stack([
            torch.stack([iz, zero, -p[..., 0] * iz * iz], dim=-1),
            torch.stack([zero, iz, -p[..., 1] * iz * iz], dim=-1)], dim=-2)
        A = A * weights[..., None, None]
        Jd = torch.matmul(A, -_skew(p - t[..., None, :]))  # (..., N, 2, 3)
        J = torch.cat([Jd, A], dim=-1)                     # (..., N, 2, 6)

        H = torch.einsum('...nik,...nil->...kl', J, J)     # (..., 6, 6)
        g = torch.einsum('...nik,...ni->...k', J, r)       # (..., 6)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        damped = H + lam[..., None, None] * (
            torch.clamp(diag, min=1e-10)[..., None] * eye6)
        step = -linalg.solve_psd(damped, g)

        R_new = torch.matmul(rodrigues(step[..., :3]), R)
        t_new = t + step[..., 3:]
        _, new_cost = _proj_cost(R_new, t_new, points_3d, norm_2d, weights)
        accept = new_cost < cost
        R = torch.where(accept[..., None, None], R_new, R)
        t = torch.where(accept[..., None], t_new, t)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
    _, cost = _proj_cost(R, t, points_3d, norm_2d, weights)
    return R, t, cost


def lm_refine(points_3d: torch.Tensor, points_2d: torch.Tensor,
              weights: torch.Tensor, K: torch.Tensor,
              R0: torch.Tensor, t0: torch.Tensor, iters: int = 20
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LM refinement from a rotation-matrix initialization, scalar
    confidence weights (cpnp_m semantics).  Returns (R, t)."""
    R, t, _ = _lm_refine_batched(points_3d, points_2d, weights, K, R0, t0,
                                 iters)
    return R, t


def mirror_pose(points_3d: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The weak-perspective mirror of a pose: reflect the camera-frame cloud
    across the plane through its centroid perpendicular to the line of
    sight, then re-fit a proper rotation by weighted Procrustes."""
    pc = torch.einsum('...ij,...nj->...ni', R, points_3d) + t[..., None, :]
    return weighted_kabsch(points_3d, mirror_cloud(pc, weights), weights)


def lm_refine_dual(points_3d: torch.Tensor, points_2d: torch.Tensor,
                   weights: torch.Tensor, K: torch.Tensor,
                   R0: torch.Tensor, t0: torch.Tensor, iters: int = 20,
                   evidence_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """LM-refine the given pose and its weak-perspective mirror as one
    batch over a new leading axis of size 2; keep the one with lower cost
    or, with ``evidence_fn(R, t) -> (2, ...)``, higher evidence (the LM
    cost breaks ties within 1e-6)."""
    Rm, tm = mirror_pose(points_3d, R0, t0, weights)
    Rb = torch.stack([R0, Rm], dim=0)
    tb = torch.stack([t0, tm], dim=0)
    R, t, cost = _lm_refine_batched(points_3d[None], points_2d[None],
                                    weights[None], K[None], Rb, tb, iters)
    if evidence_fn is None:
        pick = torch.argmin(cost, dim=0)
    else:
        ev = evidence_fn(R, t)                         # (2, ...)
        tie = (ev[0] - ev[1]).abs() <= 1e-6 * (ev.abs().amax(dim=0) + 1e-12)
        pick = torch.where(tie, torch.argmin(cost, dim=0),
                           torch.argmax(ev, dim=0))
    R = torch.gather(R, 0, pick[None, ..., None, None].expand(
        (1,) + R.shape[1:]))[0]
    t = torch.gather(t, 0, pick[None, ..., None].expand((1,) + t.shape[1:]))[0]
    return R, t


def heatmap_evidence(heatmaps_nhwc: torch.Tensor, points_3d: torch.Tensor,
                     K: torch.Tensor, rates: torch.Tensor,
                     origins: torch.Tensor,
                     valid: torch.Tensor | None = None):
    """Evidence closure for :func:`lm_refine_dual`: the sum of bilinear
    heatmap values at each candidate pose's reprojected keypoints.

    heatmaps_nhwc (B, S, S, Kp); points_3d (B, Kp, 3); rates (B,); origins
    (B, 2); valid (B, Kp) bool.  Returns ``fn(R, t) -> (..., B)`` for
    stacked candidates (2, B, 3, 3) / (2, B, 3).  Taps outside the crop
    contribute zero.
    """
    b, s = heatmaps_nhwc.shape[0], heatmaps_nhwc.shape[1]
    kp = heatmaps_nhwc.shape[-1]
    hm_flat = heatmaps_nhwc.permute(0, 3, 1, 2).reshape(b, kp, s * s).to(
        torch.float32)                                  # (B, Kp, S*S)
    vmask = (torch.ones((b, kp), dtype=torch.float32,
                        device=heatmaps_nhwc.device)
             if valid is None else valid.to(torch.float32))
    batch_ndim = points_3d.dim() - 2

    def fn(R, t):
        lead = R.shape[:R.dim() - 2 - batch_ndim]
        p3 = points_3d.expand(lead + points_3d.shape)
        pc = torch.einsum('...ij,...nj->...ni', R, p3) + t[..., None, :]
        z = torch.clamp(pc[..., 2], min=1e-6)
        xy = pc[..., :2] / z[..., None]
        fx, fy = K[..., 0, 0], K[..., 1, 1]
        cx, cy = K[..., 0, 2], K[..., 1, 2]
        if fx.dim():                                    # per-batch K
            fx, fy, cx, cy = (a[..., None] for a in (fx, fy, cx, cy))
        px = xy[..., 0] * fx + cx                       # full-frame pixels
        py = xy[..., 1] * fy + cy
        cxp = (px - origins[..., 0:1].to(torch.float32)) * rates[..., None]
        cyp = (py - origins[..., 1:2].to(torch.float32)) * rates[..., None]
        x0f = torch.floor(cxp)
        y0f = torch.floor(cyp)
        x0 = x0f.to(torch.int64)
        y0 = y0f.to(torch.int64)
        fxw = cxp - x0f
        fyw = cyp - y0f
        flat = hm_flat.expand(lead + hm_flat.shape)

        def tap(yy, xx):
            inb = (xx >= 0) & (xx < s) & (yy >= 0) & (yy < s)
            idx = torch.clamp(yy, 0, s - 1) * s + torch.clamp(xx, 0, s - 1)
            v = torch.gather(flat, -1, idx[..., None])[..., 0]
            return v * inb.to(torch.float32)

        val = (tap(y0, x0) * (1 - fxw) * (1 - fyw)
               + tap(y0, x0 + 1) * fxw * (1 - fyw)
               + tap(y0 + 1, x0) * (1 - fxw) * fyw
               + tap(y0 + 1, x0 + 1) * fxw * fyw)
        return (val * vmask).sum(-1)                    # (..., B)

    return fn


def draw_ransac_uniforms(generator: torch.Generator | None,
                         batch: tuple[int, ...], n_points: int, n_hyp: int,
                         device=None) -> torch.Tensor:
    """The random half of :func:`ransac_epnp`'s sampling: (..., n_hyp,
    n_points) uniforms in [0, 1) from ``generator``.  Their shape depends
    on shapes alone, so a caller can draw them before a CUDA graph of the
    solver and feed them in through ``uniforms=`` (the JAX ``key``
    argument of the jitted program)."""
    return torch.rand(tuple(batch) + (n_hyp, n_points), generator=generator,
                      device=device)


def _sample_masks(generator: torch.Generator | None, batch: tuple[int, ...],
                  n_points: int, n_hyp: int, sample_size: int,
                  valid: torch.Tensor,
                  uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """(..., n_hyp, N) masks of ``sample_size`` distinct valid points:
    Gumbel top-k over the valid set (sampling without replacement, no
    rejection loop), from ``uniforms`` or, without them, from uniforms
    drawn from ``generator``.  The bits differ from JAX's; tests inject
    JAX masks through ``ransac_epnp(masks=...)``."""
    u = (draw_ransac_uniforms(generator, batch, n_points, n_hyp,
                              valid.device) if uniforms is None else uniforms)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    g = torch.where(valid[..., None, :], g, -torch.inf)
    idx = torch.topk(g, sample_size, dim=-1).indices          # (..., H, S)
    masks = torch.zeros_like(g)
    return masks.scatter_(-1, idx, 1.0)


def ransac_epnp(points_3d: torch.Tensor, points_2d: torch.Tensor,
                K: torch.Tensor, generator: torch.Generator | None = None,
                valid: torch.Tensor | None = None,
                reproj_threshold: float = 5.0,
                n_hypotheses: int = 64,
                sample_size: int = 6,
                lm_iters: int = 10,
                masks: torch.Tensor | None = None,
                uniforms: torch.Tensor | None = None) -> PnPResult:
    """RANSAC-EPnP, batched over any leading dims.

    points_3d (..., N, 3); points_2d (..., N, 2) pixels; valid (..., N)
    bool mask of usable correspondences.  ``masks`` (..., H, N) injects the
    hypothesis samples (the tests feed the JAX package's); otherwise they
    come from ``uniforms`` (:func:`draw_ransac_uniforms`), or are drawn
    from ``generator`` on the points' device.  Hypotheses use the
    closed-form beta1 only (beta refinement when ``sample_size < 6``); the
    best by inlier count, then mean inlier error, is re-fitted on its
    inliers (or on all valid points when it has fewer than 4) and refined
    by LM.
    """
    batch = points_3d.shape[:-2]
    n = points_3d.shape[-2]
    v = (torch.ones(batch + (n,), dtype=torch.bool, device=points_3d.device)
         if valid is None else valid)
    vf = v.to(points_3d.dtype)

    sample_size = min(sample_size, n)
    if masks is None:
        masks = _sample_masks(generator, batch, n, n_hypotheses, sample_size,
                              v, uniforms)
    masks = masks.to(points_3d.dtype)
    hyp_refine = sample_size < 6

    shared = epnp_precompute(points_3d, points_2d, K)
    shared_h = EpnpShared(
        points_3d=shared.points_3d[..., None, :, :],
        alphas=shared.alphas[..., None, :, :],
        G=shared.G[..., None, :, :, :],
        dist_w=shared.dist_w[..., None, :],
    )
    pts_cam = epnp_reconstruct(shared_h, masks, refine_betas=hyp_refine)
    z = torch.where(pts_cam[..., 2].abs() < 1e-6, 1e-6, pts_cam[..., 2])
    proj = pts_cam[..., :2] / z[..., None]                       # (...,H,N,2)
    norm_2d = normalize_points_2d(points_2d, K)[..., None, :, :]
    fxy = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    dpix = (proj - norm_2d) * fxy[..., None, None, :]
    errs = torch.linalg.vector_norm(dpix, dim=-1)                # (..., H, N)

    inl = (errs < reproj_threshold) & v[..., None, :]
    n_inl = inl.sum(-1)                                          # (..., H)
    mean_err = (torch.where(inl, errs, 0.0).sum(-1)
                / torch.clamp(n_inl, min=1))
    score = n_inl.to(errs.dtype) - mean_err / (reproj_threshold * 4.0)
    best = torch.argmax(score, dim=-1)                           # (...,)

    best_inl = torch.gather(
        inl, -2, best[..., None, None].expand(batch + (1, n)))[..., 0, :]
    enough = (best_inl.sum(-1) >= 4)[..., None]
    fit_w = torch.where(enough, best_inl.to(vf.dtype), vf)
    R_fit, t_fit = epnp_from_mask(shared, fit_w)
    R, t, cost = _lm_refine_batched(points_3d, points_2d, fit_w, K,
                                    R_fit, t_fit, lm_iters)
    final_inl = (reprojection_errors(points_3d, points_2d, R, t, K)
                 < reproj_threshold) & v
    return PnPResult(R=R, t=t, inliers=final_inl, cost=cost)
