"""The training loss of the plain reference: HeatmapWing weighted by
``W * M + 1`` and reduced by the mean (the reference's ``loss.py:61-80``
and ``116-129``, ``main.py:378-380``)."""

from __future__ import annotations

import torch


def heatmap_wing(y_pred: torch.Tensor, y: torch.Tensor, alpha: float = 2.1,
                 omega: float = 14.0, epsilon: float = 2.0,
                 theta: float = 0.5) -> torch.Tensor:
    """omega * log(1 + |d / (eps - y)|^(alpha - y)) where |d| < theta,
    else |d| - C, with C making the two meet at theta."""
    d = torch.abs(y - y_pred)
    denom = epsilon - y
    expo = alpha - y
    near = omega * torch.log1p(torch.abs(d / denom) ** expo)
    C = theta - omega * torch.log1p((theta / denom) ** expo)
    return torch.where(d < theta, near, d - C)


def weighted_heatmap_loss(y_pred: torch.Tensor, y: torch.Tensor,
                          weight_map: torch.Tensor, W: float = 10.0
                          ) -> torch.Tensor:
    return torch.mean(heatmap_wing(y_pred, y) * (W * weight_map + 1.0))
