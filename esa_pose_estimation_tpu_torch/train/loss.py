"""Heatmap regression losses (torch port of the JAX package's
``train/loss.py``; reference loss.py:9-156).

Branch-free with ``where`` masks, as the JAX package writes them:

* :func:`heatmap_wing` — ``HeatmapWing`` (loss.py:61-80), the ESA training
  loss, with the target-dependent wing width ``epsilon - y``;
* :func:`adaptive_wing` — ``AWing`` (loss.py:40-59);
* :func:`wing` — ``WingLoss`` (loss.py:99-114);
* :func:`smooth_l1` — ``Smooth_l1`` (loss.py:84-95);
* :func:`focal_l2` — ``focal_l2_loss`` (loss.py:9-31);
* :func:`wloss` — ``WLoss`` (loss.py:145-156);
* :func:`weighted_heatmap_loss` — ``Loss_weighted`` (loss.py:116-129):
  HeatmapWing * (W*M + 1), reduced by mean (main.py:380).

All but the last two return per-element loss maps.
"""

from __future__ import annotations

import math

import torch


def heatmap_wing(y_pred: torch.Tensor, y: torch.Tensor, alpha: float = 2.1,
                 omega: float = 14.0, epsilon: float = 2.0,
                 theta: float = 0.5) -> torch.Tensor:
    """Near field (|d| < theta): omega * log(1 + |d/(eps - y)|^(alpha - y));
    far field: |d| - C, C = theta - omega * log(1 + (theta/(eps-y))^(alpha-y))."""
    d = torch.abs(y - y_pred)
    denom = epsilon - y                     # y in [0, 1], epsilon = 2 -> >= 1
    expo = alpha - y
    near = omega * torch.log1p(torch.abs(d / denom) ** expo)
    C = theta - omega * torch.log1p((theta / denom) ** expo)
    far = d - C
    return torch.where(d < theta, near, far)


def adaptive_wing(y_pred: torch.Tensor, y: torch.Tensor, alpha: float = 2.1,
                  omega: float = 14.0, epsilon: float = 1.0,
                  theta: float = 0.5) -> torch.Tensor:
    """AWing (reference loss.py:40-59)."""
    d = torch.abs(y - y_pred)
    expo = alpha - y
    A = (omega * (1.0 / (1.0 + (theta / epsilon) ** expo)) * expo
         * ((theta / epsilon) ** (expo - 1.0)) / epsilon)
    C = theta * A - omega * torch.log1p((theta / epsilon) ** expo)
    near = omega * torch.log1p(torch.abs(d / epsilon) ** expo)
    far = A * d - C
    return torch.where(d < theta, near, far)


def wing(y_pred: torch.Tensor, y: torch.Tensor, omega: float = 10.0,
         epsilon: float = 2.0, theta: float = 0.5) -> torch.Tensor:
    """WingLoss (reference loss.py:99-114)."""
    d = torch.abs(y - y_pred)
    C = theta - omega * math.log1p(theta / epsilon)
    return torch.where(d < theta, omega * torch.log1p(d / epsilon), d - C)


def smooth_l1(y_pred: torch.Tensor, y: torch.Tensor,
              theta: float = 0.5) -> torch.Tensor:
    """Smooth_l1 (reference loss.py:84-95)."""
    d = torch.abs(y - y_pred)
    return torch.where(d < theta, 0.5 * d * d, d - 0.375)


def wloss(y_pred: torch.Tensor, y: torch.Tensor, omega: float = 10.0,
          epsilon: float = 2.0) -> torch.Tensor:
    """WLoss (reference loss.py:145-156): omega * log(1 + |d| / epsilon)
    everywhere (the reference computes a constant C but never applies it)."""
    return omega * torch.log1p(torch.abs(y_pred - y) / epsilon)


def focal_l2(y_pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             gamma: float = 2.0) -> torch.Tensor:
    """focal_l2_loss (reference loss.py:9-31): the per-sample sum over all
    but the leading axis."""
    st = torch.where(y >= 0.01, y_pred, 1.0 - y_pred)
    factor = (1.0 - st) ** gamma
    out = (y_pred - y) ** 2 * factor * mask
    return out.sum(dim=tuple(range(1, out.dim())))


def weighted_heatmap_loss(y_pred: torch.Tensor, y: torch.Tensor,
                          weight_map: torch.Tensor, W: float = 10.0,
                          alpha: float = 2.1, omega: float = 14.0,
                          epsilon: float = 2.0,
                          theta: float = 0.5) -> torch.Tensor:
    """Loss_weighted (reference loss.py:116-129) reduced to the scalar mean
    of HeatmapWing(pred, y) * (W * M + 1) (main.py:378-380)."""
    lm = heatmap_wing(y_pred, y, alpha, omega, epsilon, theta)
    return torch.mean(lm * (W * weight_map + 1.0))
