"""6-DoF pose metrics of the LINEMOD family and the running mean of the
evaluation loops (torch port of the JAX package's ``eval/evaluator.py``;
reference evaluation.py:14-29, 326-532).

* ADD / ADD-S (symmetric, nearest neighbour) — evaluation.py:356-397; the
  symmetric search replaces the CUDA ``find_nearest_point_idx`` kernel with
  pairwise-distance products over blocks of query points;
* 2D projection error — evaluation.py:340-354;
* 5 cm / 5 degrees — evaluation.py:399-411;
* :class:`AverageMeter` — evaluation.py:14-29.
"""

from __future__ import annotations

import torch

from esa_pose_estimation_tpu_torch.core.camera import project_points


def _transform(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor
               ) -> torch.Tensor:
    return torch.einsum('...ij,nj->...ni', R, pts) + t[..., None, :]


def add_error(model_pts: torch.Tensor, R_pred, t_pred, R_gt, t_gt
              ) -> torch.Tensor:
    """Mean 3D distance between the model points under the two poses
    (evaluation.py:356-384) -> (...,) metres."""
    a = _transform(model_pts, R_pred, t_pred)
    b = _transform(model_pts, R_gt, t_gt)
    return torch.linalg.vector_norm(a - b, dim=-1).mean(-1)


def adds_error(model_pts: torch.Tensor, R_pred, t_pred, R_gt, t_gt,
               chunk: int = 2048) -> torch.Tensor:
    """Symmetric ADD: the mean nearest-neighbour distance
    (evaluation.py:386-397).  Query points go in blocks of ``chunk``, so
    the peak is one (..., chunk, N) distance block."""
    a = _transform(model_pts, R_pred, t_pred)       # (..., N, 3)
    b = _transform(model_pts, R_gt, t_gt)
    b2 = (b * b).sum(-1)[..., None, :]
    mins = []
    for c0 in range(0, a.shape[-2], chunk):
        blk = a[..., c0:c0 + chunk, :]
        a2 = (blk * blk).sum(-1)[..., :, None]
        ab = torch.einsum('...ni,...mi->...nm', blk, b)
        d2 = torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)
        mins.append(torch.sqrt(d2.amin(dim=-1)))
    return torch.cat(mins, dim=-1).mean(-1)


def projection_error_2d(model_pts: torch.Tensor, K: torch.Tensor,
                        R_pred, t_pred, R_gt, t_gt) -> torch.Tensor:
    """Mean 2D reprojection distance in pixels (evaluation.py:340-354)."""
    a = project_points(model_pts, R_pred, t_pred, K)
    b = project_points(model_pts, R_gt, t_gt, K)
    return torch.linalg.vector_norm(a - b, dim=-1).mean(-1)


def cm_degree_error(R_pred, t_pred, R_gt, t_gt
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation error in cm, rotation error in degrees)
    (evaluation.py:399-411)."""
    t_cm = torch.linalg.vector_norm(t_pred - t_gt, dim=-1) * 100.0
    tr = (R_pred * R_gt).sum((-2, -1))
    ang = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0,
                                                 -1.0, 1.0)))
    return t_cm, ang


def pose_accuracy(model_pts: torch.Tensor, diameter: float, K: torch.Tensor,
                  R_pred, t_pred, R_gt, t_gt, symmetric: bool = False
                  ) -> dict[str, torch.Tensor]:
    """The reference's evaluate() triple (evaluation.py:450-468, 526-532):
    the share of poses within 5 px of 2D projection error, within 0.1
    diameter of ADD (ADD-S when ``symmetric``), and within 5 cm and 5
    degrees.  Device scalars."""
    addf = adds_error if symmetric else add_error
    add = addf(model_pts, R_pred, t_pred, R_gt, t_gt)
    proj = projection_error_2d(model_pts, K, R_pred, t_pred, R_gt, t_gt)
    t_cm, ang = cm_degree_error(R_pred, t_pred, R_gt, t_gt)
    return {
        'projection_2d': (proj < 5.0).to(torch.float32).mean(),
        'add': (add < 0.1 * diameter).to(torch.float32).mean(),
        'cm_degree_5': ((t_cm < 5.0) & (ang < 5.0)).to(torch.float32).mean(),
    }


def average_precision(scores: torch.Tensor, correct: torch.Tensor
                      ) -> torch.Tensor:
    """AP of a ranked detection list: the sum over hits of precision@k
    over the number of positives.  A stable sort keeps tied scores in
    index order, as JAX's ``argsort``."""
    order = torch.sort(-scores, stable=True).indices
    c = correct[order].to(torch.float32)
    cum = torch.cumsum(c, 0)
    ranks = torch.arange(1, c.shape[0] + 1, dtype=torch.float32,
                         device=c.device)
    return (cum / ranks * c).sum() / torch.clamp(c.sum(), min=1.0)


class AverageMeter:
    """Running mean/sum/count (reference: evaluation.py:14-29)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
