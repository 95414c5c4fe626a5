"""Parametric pose NMS, AlphaPose-style pPose-NMS (torch port of the JAX
package's ``ops/pose_nms.py``).

The reference's kp6d pose NMS (kp6d/p_poseNMS.py:17-111 driver, the
parametric similarity :239-266, PCK matching :269-280, the score-weighted
merge ``p_merge_fast`` :198-236, constants :8-14).  Its greedy
delete-while loop over a shrinking candidate list becomes a fixed N
steps over alive masks, as the JAX ``fori_loop``, so no step reads a
value back to the host.

Reference constants: delta1=1, mu=1.7, delta2=1.3, gamma=22.48,
scoreThreds=0.15, matchThreds=5, alpha=0.1, merge radius min(ref_dist,
15), PCK radius min(ref_dist, 7).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import torch

DELTA1 = 1.0
MU = 1.7
DELTA2 = 1.3
GAMMA = 22.48
SCORE_THRESH = 0.15
MATCH_THRESH = 5
ALPHA = 0.1


class PoseNmsResult(NamedTuple):
    poses: torch.Tensor           # (N, K, 2) merged poses, one per slot
    scores: torch.Tensor          # (N, K) merged keypoint scores
    proposal_score: torch.Tensor  # (N,)
    valid: torch.Tensor           # (N,) bool


def pose_nms(poses: torch.Tensor, scores: torch.Tensor,
             ref_dists: torch.Tensor) -> PoseNmsResult:
    """poses (N, K, 2); scores (N, K) in [0, 1]; ref_dists (N,), each
    candidate's scale alpha * max(w, h) (p_poseNMS.py:36-39).  Returns up
    to N merged poses; ``valid`` marks the filled slots."""
    n = poses.shape[0]
    dev = poses.device
    scores = torch.clamp(torch.where(scores <= SCORE_THRESH, 1e-5, scores),
                         0.0, 1.0)
    mean_scores = scores.mean(dim=-1)
    dists = torch.linalg.vector_norm(poses[:, None] - poses[None, :],
                                     dim=-1)                  # (N, N, K)
    # the parametric similarity of candidate j to pick i (:239-266)
    tanh_s = torch.tanh(scores / DELTA1)
    score_term = torch.einsum('ik,jk,ijk->ij', tanh_s, tanh_s,
                              (dists <= 1.0).to(scores.dtype))
    point_term = torch.exp(-dists / DELTA2).sum(dim=-1)
    simi = score_term + MU * point_term                       # (N, N)
    # PCK matches of candidate j to pick i (:269-280)
    pck_r = torch.clamp(ref_dists, max=7.0)
    matches = (dists / pck_r[:, None, None] <= 1.0).sum(dim=-1)

    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    picks = torch.zeros((n,), dtype=torch.int64, device=dev)
    clusters = torch.zeros((n, n), dtype=torch.bool, device=dev)
    valids = torch.zeros((n,), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(-torch.inf, device=dev)
    for step in range(n):
        pick = torch.argmax(torch.where(alive, mean_scores, neg_inf))
        del_mask = alive & ((simi[pick] > GAMMA)
                            | (matches[pick] >= MATCH_THRESH))
        del_mask = del_mask | (torch.arange(n, device=dev) == pick)
        picks[step] = pick
        clusters[step] = del_mask & alive
        valids[step] = alive.any()
        alive = alive & ~del_mask

    # the score-weighted merge per pick (p_merge_fast, :198-236)
    ref_pose = poses[picks]                                   # (N, K, 2)
    merge_r = torch.clamp(ref_dists[picks], max=15.0)
    d_ref = torch.linalg.vector_norm(ref_pose[:, None] - poses[None, :],
                                     dim=-1)                  # (S, N, K)
    member = ((d_ref <= merge_r[:, None, None])
              & clusters[:, :, None]).to(scores.dtype)
    w = member * scores[None, :, :]
    wsum = torch.clamp(w.sum(dim=1), min=1e-9)
    wn = w / wsum[:, None, :]
    merged_pose = torch.einsum('snk,nkc->skc', wn, poses)
    merged_score = (w * wn).sum(dim=1)
    max_score = merged_score.amax(dim=-1)
    valid = valids & (max_score >= SCORE_THRESH)
    proposal = merged_score.mean(dim=-1) + 1.25 * max_score
    return PoseNmsResult(poses=merged_pose, scores=merged_score,
                         proposal_score=torch.where(valid, proposal, 0.0),
                         valid=valid)


def ref_dists_from_bboxes(bboxes: torch.Tensor) -> torch.Tensor:
    """alpha * max(width, height) per box (p_poseNMS.py:32-39)."""
    w = bboxes[..., 2] - bboxes[..., 0]
    h = bboxes[..., 3] - bboxes[..., 1]
    return ALPHA * torch.maximum(w, h)


def write_json(all_results, output_path: str, for_eval: bool = False
               ) -> str:
    """COCO/AlphaPose-style results (p_poseNMS.py:283-314).

    all_results: iterable of {'imgname': str, 'result': [{'keypoints'
    (K, 2), 'kp_score' (K,), 'proposal_score'}, ...]}, e.g. the valid slots
    of :func:`pose_nms`.  Writes ``alphapose-results.json`` under
    ``output_path`` and returns its path; ``for_eval`` writes integer image
    ids (the reference's trailing-number rule) in place of file names.
    """
    json_results = []
    for im_res in all_results:
        base = str(im_res['imgname']).split('/')[-1]
        for human in im_res['result']:
            kp = torch.as_tensor(human['keypoints']).reshape(-1, 2)
            ks = torch.as_tensor(human['kp_score']).reshape(-1)
            flat = []
            for n in range(ks.shape[0]):
                flat += [float(kp[n, 0]), float(kp[n, 1]), float(ks[n])]
            json_results.append({
                'image_id': (int(base.split('.')[0].split('_')[-1])
                             if for_eval else base),
                'category_id': 1,
                'keypoints': flat,
                'score': float(human['proposal_score']),
            })
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, 'alphapose-results.json')
    with open(path, 'w') as f:
        f.write(json.dumps(json_results))
    return path
