"""The serving pipeline: frames -> boxes -> crops -> keypoints -> pose.

Torch port of the JAX package's ``pipeline.py`` (``infer_poses``,
``infer_poses_from_crops``).  Stages:

  1. square crop x1.05 + resize   -- ops/crop.py (data_load4.py:110-166)
  2. HRNet heatmaps               -- models/hrnet.py (seg_hrnet3 forward)
  3. peak decode + log-Taylor     -- ops/peak.py -> the CUDA kernel on the card
  4. confidence top-k select      -- demo.py:195-200 / val.py:172-177
  5. RANSAC-EPnP + dual LM refine -- ops/pnp.py
  6. quaternion output            -- demo.py:301-303

Every stage follows the device of its inputs and runs batched with no host
read-back.  Each stage runs inside a ``torch.profiler.record_function``
range (``crop``, ``hrnet``, ``decode``, ``ransac_epnp``, ``refine``) so a
profiler trace attributes time per stage; with no profiler running a
range costs a few microseconds of host time.  The detector stage waits
for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.core.camera import rotmat_to_quat
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops
from esa_pose_estimation_tpu_torch.ops import peak as peak_ops
from esa_pose_estimation_tpu_torch.ops import pnp as pnp_mod


class PoseOutput(NamedTuple):
    quat: torch.Tensor          # (B, 4) (w, x, y, z)
    trans: torch.Tensor         # (B, 3)
    R: torch.Tensor             # (B, 3, 3)
    keypoints_2d: torch.Tensor  # (B, K, 2) full-frame pixel predictions
    confidences: torch.Tensor   # (B, K) heatmap peak values
    selected: torch.Tensor      # (B, K) bool keypoints used for the pose
    heatmaps: torch.Tensor      # (B, S, S, K) network output
    rates: torch.Tensor         # (B,) crop rate (uncrop: pred/rate+origin)
    origins: torch.Tensor       # (B, 2) crop top-left


@torch.no_grad()
def infer_poses(model, frames: torch.Tensor, bboxes: torch.Tensor,
                points_3d: torch.Tensor,
                generator: torch.Generator | None = None,
                K: torch.Tensor | None = None,
                crop_size: int = 128,
                conf_threshold: float = 0.6,
                min_keypoints: int = 24,
                n_hypotheses: int = 32,
                sample_size: int = 6,
                lm_iters: int = 10,
                norm_mean: float = 0.449,
                norm_std: float = 0.229,
                disambiguate: bool = True,
                crop_rule: str = 'train',
                flip_tta: bool = False,
                mirror_evidence: str = 'heatmap',
                ransac_masks: torch.Tensor | None = None) -> PoseOutput:
    """Batched frames + detector boxes -> poses.

    frames (B, H, W) grayscale [0, 255]; bboxes (B, 4) [x1, y1, x2, y2];
    points_3d (K, 3) model keypoints.  ``model`` is an :class:`HRNet` on the
    frames' device.  ``generator`` draws the RANSAC samples (on the frames'
    device); ``ransac_masks`` (B, n_hypotheses, K) injects them instead.
    ``crop_rule``: 'train' = ESADataSet box rule, 'val' = the submission
    rule without square-equalization.
    """
    if crop_rule not in ('train', 'val'):
        raise ValueError(f'unknown crop_rule {crop_rule!r}')
    with record_function('crop'):
        crops, rates, origins = crop_ops.crop_resize(
            frames, bboxes, crop_size, img_w=frames.shape[2],
            img_h=frames.shape[1], force_square=crop_rule == 'train')
    return infer_poses_from_crops(
        model, crops, rates, origins, points_3d, generator, K=K,
        conf_threshold=conf_threshold, min_keypoints=min_keypoints,
        n_hypotheses=n_hypotheses, sample_size=sample_size,
        lm_iters=lm_iters, norm_mean=norm_mean, norm_std=norm_std,
        disambiguate=disambiguate, flip_tta=flip_tta,
        mirror_evidence=mirror_evidence, ransac_masks=ransac_masks)


@torch.no_grad()
def infer_poses_from_crops(model, crops: torch.Tensor, rates: torch.Tensor,
                           origins: torch.Tensor, points_3d: torch.Tensor,
                           generator: torch.Generator | None = None,
                           K: torch.Tensor | None = None,
                           conf_threshold: float = 0.6,
                           min_keypoints: int = 24,
                           n_hypotheses: int = 32,
                           sample_size: int = 6,
                           lm_iters: int = 10,
                           norm_mean: float = 0.449,
                           norm_std: float = 0.229,
                           disambiguate: bool = True,
                           flip_tta: bool = False,
                           mirror_evidence: str = 'heatmap',
                           ransac_masks: torch.Tensor | None = None
                           ) -> PoseOutput:
    """The serving tail from cropped imagery: normalize -> HRNet -> decode
    -> select -> uncrop -> RANSAC-EPnP -> dual LM.

    crops (B, S, S) [0, 255]; rates (B,); origins (B, 2), as
    ``ops.crop.crop_resize`` returns them.
    """
    dev = crops.device
    if K is None:
        K = torch.as_tensor(camera.SPEED_K, dtype=torch.float32, device=dev)
    points_3d = points_3d.to(device=dev, dtype=torch.float32)
    with record_function('hrnet'):
        x = crop_ops.normalize(crops, norm_mean, norm_std)[..., None]
        hm = model(x)                                      # (B, S, S, K)
        if flip_tta:
            # forward the mirrored crop, un-flip its heatmaps, average
            # (SPEED's 30 keypoints have no left/right pairs: the channel
            # swap is the identity)
            hm_f = model(torch.flip(x, dims=(2,)))
            hm = (hm + torch.flip(hm_f, dims=(2,))) * 0.5
    with record_function('decode'):
        coords, maxvals = peak_ops.decode_heatmaps_auto_nhwc(hm)
        sel = peak_ops.select_confident(maxvals, conf_threshold,
                                        min_count=min_keypoints)
        uncropped = (coords / rates[:, None, None]
                     + origins[:, None, :].to(torch.float32))
    p3 = points_3d.expand((crops.shape[0],) + points_3d.shape)
    with record_function('ransac_epnp'):
        init = pnp_mod.ransac_epnp(p3, uncropped, K, generator, valid=sel,
                                   n_hypotheses=n_hypotheses,
                                   sample_size=sample_size,
                                   lm_iters=lm_iters, masks=ransac_masks)
    with record_function('refine'):
        # final confidence-weighted refinement over the RANSAC inliers,
        # falling back to the selection when the inlier set is degenerate
        keep = init.inliers & sel
        enough = (keep.sum(-1) >= 4)[..., None]
        keep = torch.where(enough, keep, sel)
        w = torch.where(keep, maxvals, 0.0)
        if disambiguate:
            ev_fn = None
            if mirror_evidence == 'heatmap':
                ev_fn = pnp_mod.heatmap_evidence(hm.to(torch.float32), p3,
                                                 K, rates, origins,
                                                 valid=sel)
            R, t = pnp_mod.lm_refine_dual(p3, uncropped, w, K, init.R,
                                          init.t, iters=lm_iters,
                                          evidence_fn=ev_fn)
        else:
            R, t = pnp_mod.lm_refine(p3, uncropped, w, K, init.R, init.t,
                                     iters=lm_iters)
    return PoseOutput(quat=rotmat_to_quat(R), trans=t, R=R,
                      keypoints_2d=uncropped, confidences=maxvals,
                      selected=sel, heatmaps=hm, rates=rates,
                      origins=origins)
