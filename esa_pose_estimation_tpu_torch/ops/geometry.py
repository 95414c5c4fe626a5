"""Point-cloud geometry: farthest point sampling and nearest neighbours
(torch port of the JAX package's ``ops/geometry.py``).

* :func:`farthest_point_sampling` — the reference's C++ FPS
  (lib/utils/extend_utils/src/farthest_point_sampling.cpp:40-207) that picks
  the canonical PVNet keypoints of a mesh: the distance updates are one
  vector operation per step, only the k selection steps are sequential.
* :func:`nearest_neighbor_index` / :func:`nearest_neighbor_distance` — the
  CUDA nearest-neighbour search (src/nearest_neighborhood.cu:48-167) of the
  symmetric ADD metric, as one pairwise-distance product.
"""

from __future__ import annotations

import torch


def farthest_point_sampling(points: torch.Tensor, k: int,
                            init_center: bool = True) -> torch.Tensor:
    """Select k points maximizing mutual distance: (N, 3) -> indices (k,)
    int64.  ``init_center=True`` starts from the point closest to the
    centroid; first occurrence wins every argmin/argmax tie, as in JAX."""
    if init_center:
        centroid = points.mean(dim=0)
        first = torch.argmin(torch.linalg.vector_norm(points - centroid,
                                                      dim=-1))
    else:
        first = torch.zeros((), dtype=torch.int64, device=points.device)
    dist = torch.linalg.vector_norm(points - points[first], dim=-1)
    picked = [first]
    for _ in range(k - 1):
        nxt = torch.argmax(dist)
        picked.append(nxt)
        dist = torch.minimum(dist, torch.linalg.vector_norm(
            points - points[nxt], dim=-1))
    return torch.stack(picked)


def _pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.einsum('...ni,...mi->...nm', a, b)
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def nearest_neighbor_index(query: torch.Tensor,
                           reference: torch.Tensor) -> torch.Tensor:
    """Index of the nearest reference point per query -> (..., N)."""
    return torch.argmin(_pairwise_sq_dist(query, reference), dim=-1)


def nearest_neighbor_distance(query: torch.Tensor,
                              reference: torch.Tensor) -> torch.Tensor:
    """Distance to the nearest reference point per query -> (..., N)."""
    return torch.sqrt(_pairwise_sq_dist(query, reference).amin(dim=-1))
