"""Batched non-maximum suppression on the device (torch port of the JAX
package's ``ops/nms.py``).

Fixed-size, mask-based greedy NMS: the candidates are sorted by score, and
suppression is a sequential loop over the sorted list (greedy NMS is
ordered) with the IoU tests of each step vectorised over the batch and the
candidates.  N steps of O(N) vector work, no host read-back.

Ties: the JAX package sorts with ``jnp.argsort`` and ``lax.top_k``, which
put equal values in index order.  ``torch.topk`` makes no such promise on
CUDA, so both sorts here are ``stable=True`` sorts: the kept set and its
order match JAX's on tied scores.
"""

from __future__ import annotations

import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. boxes: (..., N, 4) / (..., M, 4) as [x1, y1, x2, y2]
    -> (..., N, M)."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(boxes_a[..., 2] - boxes_a[..., 0], min=0.0)
              * torch.clamp(boxes_a[..., 3] - boxes_a[..., 1], min=0.0))
    area_b = (torch.clamp(boxes_b[..., 2] - boxes_b[..., 0], min=0.0)
              * torch.clamp(boxes_b[..., 3] - boxes_b[..., 1], min=0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.45,
                score_threshold: float = 0.25,
                max_outputs: int = 16
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over a (possibly batched) fixed-size candidate set.

    boxes: (..., N, 4); scores: (..., N).
    Returns (boxes (..., max_outputs, 4), scores (..., max_outputs),
    valid (..., max_outputs) bool), score-sorted; suppressed and overflow
    slots have score 0 and valid False.
    """
    n = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    scores_s = torch.gather(scores, -1, order)

    iou = iou_matrix(boxes_s, boxes_s)                       # (..., N, N)
    alive = scores_s > score_threshold
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        suppress = (iou[..., i, :] > iou_threshold) & alive[..., i, None]
        alive = alive & ~(suppress & (later > i))

    kept = torch.where(alive, scores_s, 0.0)
    k = min(max_outputs, n)
    top_scores, top_idx = torch.sort(kept, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    top_boxes = torch.gather(
        boxes_s, -2, top_idx[..., None].expand(top_idx.shape + (4,)))
    if k < max_outputs:
        pad = max_outputs - k
        top_scores = torch.cat([top_scores, top_scores.new_zeros(
            top_scores.shape[:-1] + (pad,))], dim=-1)
        top_boxes = torch.cat([top_boxes, top_boxes.new_zeros(
            top_boxes.shape[:-2] + (pad, 4))], dim=-2)
    valid = top_scores > score_threshold
    return top_boxes, top_scores, valid
