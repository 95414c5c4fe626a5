"""SPEED competition metric (ESA/Kelvins 2019), batched (reference:
demo.py:295-310):

  score_t = ||t_pred - t_gt||_2 / ||t_gt||_2
  score_r = 2 * arccos(|<q_pred, q_gt>|)
  speed   = score_t + score_r
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from esa_pose_estimation_tpu_torch.core.camera import (
    normalize_quat,
    rotmat_to_quat,
)


class SpeedScores(NamedTuple):
    score_t: torch.Tensor       # (...,) relative translation error
    score_r: torch.Tensor       # (...,) rotation error [rad]
    speed: torch.Tensor         # (...,) combined score
    trans_err: torch.Tensor     # (..., 3) |dt| per axis
    angular_deg: torch.Tensor   # (...,) rotation geodesic distance [deg]


def speed_score(q_pred: torch.Tensor, t_pred: torch.Tensor,
                q_gt: torch.Tensor, t_gt: torch.Tensor) -> SpeedScores:
    """Batched SPEED score.  Quaternions (w, x, y, z), any leading dims."""
    qp = normalize_quat(q_pred)
    qg = normalize_quat(q_gt)
    score_t = (torch.linalg.vector_norm(t_pred - t_gt, dim=-1)
               / torch.linalg.vector_norm(t_gt, dim=-1))
    dot = (qp * qg).sum(-1).abs()
    score_r = 2.0 * torch.arccos(torch.clamp(dot, 0.0, 1.0))
    return SpeedScores(score_t=score_t, score_r=score_r,
                       speed=score_t + score_r,
                       trans_err=(t_pred - t_gt).abs(),
                       angular_deg=score_r * (180.0 / math.pi))


def speed_score_from_matrices(R_pred: torch.Tensor, t_pred: torch.Tensor,
                              q_gt: torch.Tensor,
                              t_gt: torch.Tensor) -> SpeedScores:
    """Score directly from [R|t] solver output (demo.py:301-303 path)."""
    return speed_score(rotmat_to_quat(R_pred), t_pred, q_gt, t_gt)
