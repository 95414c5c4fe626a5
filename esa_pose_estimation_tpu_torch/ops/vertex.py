"""Vertex-field (direction-field) targets and loss for PVNet-style models
(torch port of the JAX package's ``ops/vertex.py``; reference
lib/datasets/linemod_dataset.py:69-82 ``compute_vertex_hcoords``).

For every foreground pixel, the unit 2D vector toward each keypoint: one
broadcast subtract and normalize over (B, H, W, K, 2), masked by the
foreground.  ``ops/voting`` recovers the keypoints from such a field.
"""

from __future__ import annotations

import torch


def vertex_field(mask: torch.Tensor, keypoints_2d: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """mask (B, H, W) in {0, 1}; keypoints_2d (B, K, 2) pixel (x, y) ->
    (B, H, W, K, 2) unit vectors, zero outside the mask."""
    b, h, w = mask.shape
    dev = mask.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :,
                                                           None]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None,
                                                           None]
    dx = keypoints_2d[:, None, None, :, 0] - xs           # (B, H, W, K)
    dy = keypoints_2d[:, None, None, :, 1] - ys
    norm = torch.sqrt(dx * dx + dy * dy) + eps
    field = torch.stack([dx / norm, dy / norm], dim=-1)
    return field * mask[..., None, None]


def vertex_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                beta: float = 1.0) -> torch.Tensor:
    """Masked smooth-L1 on the direction field: foreground pixels only,
    the mean over the valid elements."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    m = mask[..., None, None]
    return (loss * m).sum() / torch.clamp(
        m.sum() * pred.shape[-1] * pred.shape[-2], min=1.0)
