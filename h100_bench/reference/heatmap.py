"""A frozen copy, for the benchmark's plain reference, of the port's
ops/heatmap.py.
It imports nothing of the port, so a later change to the port's code leaves
it as it is.  The original's first line:

Gaussian keypoint heatmaps and loss weight maps (torch port of the JAX
package's ``ops/heatmap.py``).

* :func:`render_heatmaps` replaces the reference's per-keypoint meshgrid
  loop (``CenterLabelHeatMap``, data_load4.py:54-64) with one broadcast
  ``exp`` over ``(..., K, H, W)``.
* :func:`weight_maps` is ``generate_weight_map`` (loss.py:133-139): scipy's
  3x3 ``grey_dilation`` with a flat element is a 3x3 max-pool, padded with
  -inf as ``lax.reduce_window`` pads.

Peaks land exactly on the keypoints (0-indexed grid); ``one_indexed=True``
reproduces the reference's 1-indexed meshgrid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def squared_distances(keypoints: torch.Tensor, height: int, width: int,
                      start: float = 0.0, dtype=torch.float32
                      ) -> torch.Tensor:
    """keypoints (..., K, 2) pixel (x, y) -> (..., K, height, width)
    squared distances from each pixel (grid from ``start``)."""
    dev = keypoints.device
    xs = (torch.arange(width, dtype=dtype, device=dev) + start)[None, :]
    ys = (torch.arange(height, dtype=dtype, device=dev) + start)[:, None]
    cx = keypoints[..., 0][..., None, None]
    cy = keypoints[..., 1][..., None, None]
    return (xs - cx) ** 2 + (ys - cy) ** 2


def render_heatmaps(keypoints: torch.Tensor, height: int, width: int,
                    sigma: float = 2.0, *, one_indexed: bool = False,
                    dtype=torch.float32) -> torch.Tensor:
    """keypoints (..., K, 2) pixel (x, y) -> (..., K, height, width)
    Gaussians with values in (0, 1]."""
    d2 = squared_distances(keypoints, height, width,
                           1.0 if one_indexed else 0.0, dtype)
    return torch.exp(-d2 / (2.0 * sigma * sigma)).to(dtype)


def weight_maps(heatmaps: torch.Tensor, threshold: float = 0.2
                ) -> torch.Tensor:
    """(..., H, W) heatmaps -> 1 where their 3x3 grey dilation exceeds
    ``threshold``, else the heatmap."""
    h, w = heatmaps.shape[-2:]
    dilated = F.max_pool2d(heatmaps.reshape(-1, h, w), 3, stride=1,
                           padding=1).reshape(heatmaps.shape)
    return torch.where(dilated > threshold, 1.0, heatmaps).to(heatmaps.dtype)


def render_targets(keypoints: torch.Tensor, height: int, width: int,
                   sigma: float = 2.0, *, weight_threshold: float = 0.2,
                   dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Heatmap + weight-map targets (the reference dataloader's hot path,
    data_load4.py:174-190)."""
    hm = render_heatmaps(keypoints, height, width, sigma, dtype=dtype)
    return hm, weight_maps(hm, weight_threshold)
