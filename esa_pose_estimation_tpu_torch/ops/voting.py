"""RANSAC voting keypoint localization from dense direction fields, PVNet
style (torch port of the JAX package's ``ops/voting.py``; reference
lib/ransac_voting_gpu_layer/ransac_voting_gpu.py:514-598
``ransac_voting_layer_v3`` over src/ransac_voting_kernel.cu:11-128).

As in the JAX version, and unlike the reference's data-dependent loop:

* the foreground gather has a fixed budget: Gumbel top-k over the mask
  picks ``n_points`` distinct pixels (weight ~0 when the foreground is
  smaller), so every later shape is static;
* a fixed number of hypotheses (line intersections of random pixel pairs)
  is voted in one batch, chunked over hypotheses so that one (B, chunk, N,
  K, 2) block is the peak memory;
* the winner per keypoint is refined by inlier-weighted 2x2 least squares.

Also the two hypothesis-distribution estimators that feed covariance
weighted PnP (ransac_voting_gpu.py:263-406) and the motion, center and
vanishing-point variants (:408-668, 960-981).

Randomness: every function that draws takes a ``generator`` and an
optional ``draws`` dict of the Gumbel noise it would draw
(:func:`draw_voting`): ``'gather'`` (B, H*W) and ``'pairs'`` (B, Hyp, 2,
N).  The tests inject the JAX package's draws through it.  This is plain
torch, not a kernel: whether voting earns a hand-written one is for the
card's numbers to say.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-9


class VotingResult(NamedTuple):
    """``mean`` is the ratio-thresholded centre of the hypothesis cloud;
    ``covariance`` is the cloud's second moment about ``keypoints`` (the
    reference eval convention, ransac_voting_gpu.py:392-401)."""
    keypoints: torch.Tensor      # (B, K, 2) refined winner, pixel (x, y)
    mean: torch.Tensor           # (B, K, 2)
    covariance: torch.Tensor     # (B, K, 2, 2)
    inlier_counts: torch.Tensor  # (B, K) votes for the winning hypothesis


def gumbel(generator: torch.Generator | None, shape, device=None
           ) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)), U clamped away from 0."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def draw_voting(generator: torch.Generator | None, batch: int, pixels: int,
                n_points: int, n_hypotheses: int, device=None) -> dict:
    """The draws of one voting pass: Gumbel noise for the foreground
    gather (B, pixels) and for the pair sampling (B, Hyp, 2, N), N =
    min(n_points, pixels)."""
    n = min(n_points, pixels)
    return {'gather': gumbel(generator, (batch, pixels), device),
            'pairs': gumbel(generator, (batch, n_hypotheses, 2, n), device)}


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing='ij')
    return torch.stack([xs, ys], dim=-1).reshape(h * w, 2)   # (P, 2) (x, y)


def _gather_foreground(mask: torch.Tensor, vertex: torch.Tensor,
                       noise: torch.Tensor, n_points: int):
    """Fixed-budget foreground gather: Gumbel top-k without replacement
    over log(mask).  mask (B, H, W); vertex (B, H, W, K, 2); noise (B, P).
    -> coords (B, N, 2), dirs (B, N, K, 2), weights (B, N)."""
    b, h, w = mask.shape
    k = vertex.shape[3]
    p = h * w
    m = mask.reshape(b, p).to(torch.float32)
    g = noise + torch.log(torch.clamp(m, min=1e-20))
    idx = torch.topk(g, min(n_points, p), dim=1).indices       # (B, N)
    coords = _pixel_grid(h, w, mask.device)[idx]               # (B, N, 2)
    wt = torch.gather(m, 1, idx)
    d = vertex.reshape(b, p, k, 2)
    dirs = torch.gather(d, 1, idx[:, :, None, None].expand(-1, -1, k, 2))
    return coords, dirs, wt


def _sample_pairs(noise: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Pair indices drawn with replacement, weight proportional to ``wt``:
    noise (B, Hyp, 2, N) -> (B, Hyp, 2)."""
    g = noise + torch.log(torch.clamp(wt, min=1e-20))[:, None, None, :]
    return torch.argmax(g, dim=-1)


def _pair_gather(coords, dirs, idx):
    """(B, Hyp, 2) indices -> pixels (B, Hyp, 2, 2), dirs (B, Hyp, 2, K,
    2)."""
    b, n_hyp, _ = idx.shape
    k = dirs.shape[2]
    flat = idx.reshape(b, n_hyp * 2)
    pix = torch.gather(coords, 1, flat[..., None].expand(-1, -1, 2))
    dd = torch.gather(dirs, 1, flat[..., None, None].expand(-1, -1, k, 2))
    return pix.reshape(b, n_hyp, 2, 2), dd.reshape(b, n_hyp, 2, k, 2)


def _intersect(p1, d1, p2, d2):
    """Intersection of the lines p1 + t d1 and p2 + s d2, batched (..., 2);
    near-parallel pairs give a far point that gets no votes."""
    det = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    safe_det = torch.where(det.abs() < 1e-6,
                           torch.where(det < 0, -1e-6, 1e-6), det)
    dp = p2 - p1
    t = (dp[..., 0] * d2[..., 1] - dp[..., 1] * d2[..., 0]) / safe_det
    return p1 + t[..., None] * d1


def _generate_hypotheses(noise, coords, dirs, wt) -> torch.Tensor:
    """Random pixel pairs -> line intersections (B, Hyp, K, 2)."""
    pix, dd = _pair_gather(coords, dirs, _sample_pairs(noise, wt))
    return _intersect(pix[:, :, 0, None, :], dd[:, :, 0],
                      pix[:, :, 1, None, :], dd[:, :, 1])


def _cosines(diff, dn, dirs, dirn):
    """cos of the angle between ``diff`` and ``dirs`` over the last axis,
    both normalized (the reference normalizes both,
    ransac_voting_kernel.cu:119-123)."""
    return (diff * dirs).sum(-1) / (dn * dirn)


def _vote_counts_chunked(hyp: torch.Tensor, coords: torch.Tensor,
                         dirs: torch.Tensor, wt: torch.Tensor,
                         inlier_threshold: float, chunk: int
                         ) -> torch.Tensor:
    """Weighted inlier counts per hypothesis (B, Hyp, K), one (B, chunk, N,
    K, 2) block at a time."""
    dirn = torch.linalg.vector_norm(dirs, dim=-1) + _EPS       # (B, N, K)
    out = []
    for c0 in range(0, hyp.shape[1], chunk):
        hc = hyp[:, c0:c0 + chunk]
        diff = hc[:, :, None, :, :] - coords[:, None, :, None, :]
        dn = torch.linalg.vector_norm(diff, dim=-1) + _EPS     # (B, C, N, K)
        cos = _cosines(diff, dn, dirs[:, None], dirn[:, None])
        v = (cos > inlier_threshold).to(wt.dtype) * wt[:, None, :, None]
        out.append(v.sum(2))
    return torch.cat(out, dim=1)


def _votes_for(points, coords, dirs, wt, inlier_threshold) -> torch.Tensor:
    """Per-point weighted votes for one candidate per keypoint: points
    (B, K, 2) -> (B, N, K)."""
    diff = points[:, None, :, :] - coords[:, :, None, :]      # (B, N, K, 2)
    dn = torch.linalg.vector_norm(diff, dim=-1) + _EPS
    dirn = torch.linalg.vector_norm(dirs, dim=-1) + _EPS
    cos = _cosines(diff, dn, dirs, dirn)
    return (cos > inlier_threshold).to(wt.dtype) * wt[:, :, None]


def _take_hyp(a: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """a (B, Hyp, K[, 2]) at per-keypoint hypotheses best (B, K)."""
    idx = best[:, None, :]
    if a.dim() == 4:
        idx = idx[..., None].expand(-1, -1, -1, a.shape[-1])
    return torch.gather(a, 1, idx)[:, 0]


def ransac_voting(mask: torch.Tensor, vertex: torch.Tensor,
                  generator: torch.Generator | None = None,
                  inlier_threshold: float = 0.999,
                  n_hypotheses: int = 128, min_inliers: float = 5.0,
                  n_points: int = 2048, hyp_chunk: int = 32,
                  draws: dict | None = None) -> VotingResult:
    """Batched RANSAC voting (``ransac_voting_layer_v3`` semantics).

    mask (B, H, W) foreground weights in [0, 1]; vertex (B, H, W, K, 2)
    unit directions toward each keypoint; ``inlier_threshold`` the cosine
    threshold (reference default 0.999).  ``draws`` (:func:`draw_voting`)
    replaces the generator's.  Returns the winning hypothesis per keypoint
    refined by inlier-weighted least squares, and the hypothesis cloud's
    moments.
    """
    b, h, w = mask.shape
    if draws is None:
        draws = draw_voting(generator, b, h * w, n_points, n_hypotheses,
                            mask.device)
    coords, dirs, wt = _gather_foreground(mask, vertex, draws['gather'],
                                          n_points)
    hyp = _generate_hypotheses(draws['pairs'], coords, dirs, wt)
    counts = _vote_counts_chunked(hyp, coords, dirs, wt, inlier_threshold,
                                  hyp_chunk)                   # (B, Hyp, K)

    best = torch.argmax(counts, dim=1)                         # (B, K)
    best_counts = _take_hyp(counts, best)
    best_hyp = _take_hyp(hyp, best)                            # (B, K, 2)
    wv = _votes_for(best_hyp, coords, dirs, wt, inlier_threshold)

    # each inlier constrains n.y = n.p with n = perp(dir)
    # (ransac_voting_gpu.py:580-597, batched 2x2 normal equations)
    n_perp = torch.stack([-dirs[..., 1], dirs[..., 0]], dim=-1)
    A = torch.einsum('bnk,bnki,bnkj->bkij', wv, n_perp, n_perp)
    rhs = torch.einsum('bnk,bnki,bnkj,bnj->bki', wv, n_perp, n_perp, coords)
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    ok = (det.abs() > 1e-6) & (best_counts >= min_inliers)
    safe_det = torch.where(det.abs() < 1e-6, 1.0, det)
    inv = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1)],
        dim=-2) / safe_det[..., None, None]
    refined = torch.einsum('bkij,bkj->bki', inv, rhs)
    keypoints = torch.where(ok[..., None], refined, best_hyp)

    # ratio-thresholded moments (ransac_voting_gpu.py:392-401)
    ratio = counts / (wt.sum(1)[:, None, None] + _EPS)
    thresh = ratio.amax(dim=1, keepdim=True) - 0.1
    r = torch.where(ratio < thresh, 0.0, ratio)
    mean = (torch.einsum('bhk,bhki->bki', r, hyp)
            / (r.sum(1)[..., None] + _EPS))
    cov = distribution_moments_with_mean(hyp, ratio, keypoints)
    return VotingResult(keypoints=keypoints, mean=mean, covariance=cov,
                        inlier_counts=best_counts)


def distribution_moments_with_mean(hyp: torch.Tensor, ratio: torch.Tensor,
                                   mean: torch.Tensor) -> torch.Tensor:
    """Covariance of the hypothesis cloud around a given mean
    (ransac_voting_gpu.py:392-401): ratios below ``max - 0.1`` are zeroed,
    then ``sum_h r_h (hyp_h - mean)(hyp_h - mean)^T / (sum r + 1e-3)``.
    hyp (B, Hyp, K, 2), ratio (B, Hyp, K), mean (B, K, 2) -> (B, K, 2, 2).
    """
    thresh = ratio.amax(dim=1, keepdim=True) - 0.1
    r = torch.where(ratio < thresh, 0.0, ratio)
    dev = hyp - mean[:, None, :, :]
    cov = torch.einsum('bhk,bhki,bhkj->bkij', r, dev, dev)
    return cov / (r.sum(1)[..., None, None] + 1e-3)


def distribution_moments(hyp: torch.Tensor, ratio: torch.Tensor,
                         topk: int = 128
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k weighted mean and covariance of the hypothesis cloud
    (ransac_voting_gpu.py:318-331): the ``topk`` highest ratios per
    keypoint are kept, ties with the k-th included."""
    topk = min(topk, ratio.shape[1])
    kth = torch.topk(ratio, topk, dim=1).values[:, -1:]        # (B, 1, K)
    r = torch.where(ratio >= kth, ratio, 0.0)
    rsum = r.sum(1) + _EPS
    mean = torch.einsum('bhk,bhki->bki', r, hyp) / rsum[..., None]
    dev = hyp - mean[:, None, :, :]
    cov = torch.einsum('bhk,bhki,bhkj->bkij', r, dev, dev)
    return mean, cov / rsum[..., None, None]


def _hypothesis_cloud(mask, vertex, generator, n_hypotheses, n_points,
                      inlier_threshold, hyp_chunk, draws):
    """A fresh cloud and its inlier ratios (count / foreground weight)."""
    b, h, w = mask.shape
    if draws is None:
        draws = draw_voting(generator, b, h * w, n_points, n_hypotheses,
                            mask.device)
    coords, dirs, wt = _gather_foreground(mask, vertex, draws['gather'],
                                          n_points)
    hyp = _generate_hypotheses(draws['pairs'], coords, dirs, wt)
    counts = _vote_counts_chunked(hyp, coords, dirs, wt, inlier_threshold,
                                  hyp_chunk)
    return hyp, counts / (wt.sum(1) + _EPS)[:, None, None]


def estimate_voting_distribution(
        mask: torch.Tensor, vertex: torch.Tensor,
        generator: torch.Generator | None = None, n_hypotheses: int = 1024,
        inlier_threshold: float = 0.99, n_points: int = 2048,
        hyp_chunk: int = 32, topk: int = 128, draws: dict | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh-cloud voting distribution (mean, cov), top-k weighted
    (ransac_voting_gpu.py:263-331)."""
    hyp, ratio = _hypothesis_cloud(mask, vertex, generator, n_hypotheses,
                                   n_points, inlier_threshold, hyp_chunk,
                                   draws)
    return distribution_moments(hyp, ratio, topk=topk)


def estimate_voting_distribution_with_mean(
        mask: torch.Tensor, vertex: torch.Tensor, mean: torch.Tensor,
        generator: torch.Generator | None = None, n_hypotheses: int = 1024,
        inlier_threshold: float = 0.99, n_points: int = 2048,
        hyp_chunk: int = 32, draws: dict | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Voting distribution around a given mean -> (mean, cov (B, K, 2, 2))
    (ransac_voting_gpu.py:333-406): a fresh cloud voted at the looser 0.99
    threshold, ratios below ``max - 0.1`` discarded, the second moment
    about the supplied mean, which is returned unchanged.  The PVNet eval
    path feeds this covariance to uncertainty PnP."""
    hyp, ratio = _hypothesis_cloud(mask, vertex, generator, n_hypotheses,
                                   n_points, inlier_threshold, hyp_chunk,
                                   draws)
    return mean, distribution_moments_with_mean(hyp, ratio, mean)


def motion_voting(mask: torch.Tensor, vertex: torch.Tensor) -> torch.Tensor:
    """Motion-average keypoints (``ransac_motion_voting``,
    ransac_voting_gpu.py:960-981): the field holds per-pixel offsets to
    each keypoint; the estimate is the foreground mean of pixel + offset,
    zeros for an empty mask.  mask (B, H, W); vertex (B, H, W, K, 2) ->
    (B, K, 2)."""
    b, h, w, k, _ = vertex.shape
    grid = _pixel_grid(h, w, vertex.device).reshape(1, h * w, 1, 2)
    m = mask.reshape(b, h * w).to(vertex.dtype)
    pts = vertex.reshape(b, h * w, k, 2) + grid
    wsum = m.sum(1)[:, None, None]
    mean = torch.einsum('bp,bpki->bki', m, pts) / torch.clamp(wsum,
                                                              min=1e-12)
    return torch.where(wsum > 0, mean, 0.0)


class CenterVotingResult(NamedTuple):
    center: torch.Tensor        # (B, 2)
    inlier_mask: torch.Tensor   # (B, H, W) weighted votes for the winner
    inlier_ratio: torch.Tensor  # (B,)


def ransac_voting_center(mask: torch.Tensor, vertex: torch.Tensor,
                         generator: torch.Generator | None = None,
                         inlier_threshold: float = 0.99,
                         n_hypotheses: int = 128, n_points: int = 2048,
                         hyp_chunk: int = 32, draws: dict | None = None
                         ) -> CenterVotingResult:
    """Object-center voting (ransac_voting_gpu.py:600-668): one-channel
    voting on a center-direction field (B, H, W, 2), the winning center
    and the full-resolution map of the pixels that voted for it."""
    res = ransac_voting(mask, vertex[:, :, :, None, :], generator,
                        inlier_threshold=inlier_threshold,
                        n_hypotheses=n_hypotheses, n_points=n_points,
                        hyp_chunk=hyp_chunk, draws=draws)
    center = res.keypoints[:, 0]
    b, h, w = mask.shape
    grid = _pixel_grid(h, w, vertex.device).reshape(1, h, w, 2)
    diff = center[:, None, None, :] - grid
    dn = torch.linalg.vector_norm(diff, dim=-1) + _EPS
    dirn = torch.linalg.vector_norm(vertex, dim=-1) + _EPS
    cos = _cosines(diff, dn, vertex, dirn)
    votes = (cos > inlier_threshold).to(mask.dtype) * mask
    ratio = votes.sum((1, 2)) / (mask.sum((1, 2)) + _EPS)
    return CenterVotingResult(center=center, inlier_mask=votes,
                              inlier_ratio=ratio)


def _vanishing_hypotheses(coords, dirs, wt, noise):
    """Random pixel pairs -> homogeneous vanishing-point hypotheses
    (ransac_voting_kernel.cu:170-229): the cross product of the two pixel
    lines, sign-fixed so both rays point toward it; pairs whose rays
    disagree give the zero hypothesis."""
    pix, dd = _pair_gather(coords, dirs, _sample_pairs(noise, wt))
    c0, c1 = pix[:, :, 0, None, :], pix[:, :, 1, None, :]     # (B, Hyp, 1, 2)
    d0, d1 = dd[:, :, 0], dd[:, :, 1]                         # (B, Hyp, K, 2)

    def line(c, d):                   # (d_y, -d_x, c_y d_x - c_x d_y)
        return torch.stack([d[..., 1], -d[..., 0],
                            c[..., 1] * d[..., 0] - c[..., 0] * d[..., 1]],
                           dim=-1)
    l0, l1 = line(c0, d0), line(c1, d1)
    vp = torch.linalg.cross(l0, l1)                           # (B, Hyp, K, 3)
    x, y, z = vp[..., 0], vp[..., 1], vp[..., 2]
    vx0 = d0[..., 0] * (x - z * c0[..., 0])
    vx1 = d1[..., 0] * (x - z * c1[..., 0])
    vy0 = d0[..., 1] * (y - z * c0[..., 1])
    vy1 = d1[..., 1] * (y - z * c1[..., 1])
    # the reference's gating, including its quirk: an exactly axis-aligned
    # direction never fires the strict < 0 flip test
    flip = (vx0 < 0) & (vx1 < 0) & (vy0 < 0) & (vy1 < 0)
    vp = torch.where(flip[..., None], -vp, vp)
    bad = (vx0 * vx1 < 0) | (vy0 * vy1 < 0)
    return torch.where(bad[..., None], 0.0, vp)


def _vanishing_votes(vp, coords, dirs, wt, thresh):
    """Weighted votes for homogeneous candidates
    (ransac_voting_kernel.cu:270-313): |cos| above ``thresh`` and the
    direction agreeing per component.  vp (B, C, K, 3) -> (B, C, N, K)."""
    diff = (vp[:, :, None, :, :2]
            - coords[:, None, :, None, :] * vp[:, :, None, :, 2:])
    dn = torch.linalg.vector_norm(diff, dim=-1) + _EPS
    dirn = torch.linalg.vector_norm(dirs, dim=-1) + _EPS
    cos = _cosines(diff, dn, dirs[:, None], dirn[:, None])
    agree = ((diff[..., 0] * dirs[:, None, :, :, 0] >= 0)
             & (diff[..., 1] * dirs[:, None, :, :, 1] >= 0))
    return ((cos.abs() > thresh) & agree).to(wt.dtype) \
        * wt[:, None, :, None]


def vanishing_point_voting(mask: torch.Tensor, vertex: torch.Tensor,
                           generator: torch.Generator | None = None,
                           inlier_threshold: float = 0.999,
                           n_hypotheses: int = 128, n_points: int = 1024,
                           hyp_chunk: int = 32, refine_iters: int = 1,
                           draws: dict | None = None) -> torch.Tensor:
    """Vanishing-point RANSAC voting (ransac_voting_gpu.py:408-500):
    keypoints in homogeneous coordinates, so parallel direction fields
    (points at infinity) are first-class.  The winner is refined by the
    null vector of the weighted inlier line system H = [-n | n.c] (a 3x3
    smallest-eigenvector solve).  mask (B, H, W); vertex (B, H, W, K, 2)
    -> (B, K, 3) unit-norm homogeneous winners."""
    from esa_pose_estimation_tpu_torch.core.linalg import smallest_eigvec3

    b, h, w = mask.shape
    if draws is None:
        draws = draw_voting(generator, b, h * w, n_points, n_hypotheses,
                            mask.device)
    coords, dirs, wt = _gather_foreground(mask, vertex, draws['gather'],
                                          n_points)
    vp = _vanishing_hypotheses(coords, dirs, wt, draws['pairs'])
    counts = torch.cat([
        _vanishing_votes(vp[:, c0:c0 + hyp_chunk], coords, dirs, wt,
                         inlier_threshold).sum(2)
        for c0 in range(0, n_hypotheses, hyp_chunk)], dim=1)  # (B, Hyp, K)

    best = torch.argmax(counts, dim=1)
    win = _take_hyp(vp, best)
    win = win / (torch.linalg.vector_norm(win, dim=-1, keepdim=True) + _EPS)

    normal = torch.stack([dirs[..., 1], -dirs[..., 0]], dim=-1)
    hrow = torch.cat([-normal, (normal * coords[:, :, None, :]).sum(
        -1, keepdim=True)], dim=-1)                            # (B, N, K, 3)
    for _ in range(refine_iters):
        votes = _vanishing_votes(win[:, None], coords, dirs, wt,
                                 inlier_threshold)[:, 0]       # (B, N, K)
        M = torch.einsum('bnk,bnki,bnkj->bkij', votes, hrow, hrow)
        refined = smallest_eigvec3(M)
        refined = refined / (torch.linalg.vector_norm(
            refined, dim=-1, keepdim=True) + _EPS)
        sgn = torch.sign((refined * win).sum(-1, keepdim=True))
        refined = torch.where(sgn == 0, win, refined * sgn)
        ok = votes.sum(1) > 0
        win = torch.where(ok[..., None], refined, win)
    return win
