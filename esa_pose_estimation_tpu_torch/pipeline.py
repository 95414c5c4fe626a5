"""The serving pipeline: frames -> boxes -> crops -> keypoints -> pose.

Torch port of the JAX package's ``pipeline.py`` (``infer_poses``,
``infer_poses_from_crops``, ``make_pipeline``, and the two-stage
``detect_frames`` / ``detect_and_infer``).  Stages:

  1. detect (optional)            -- models/detector.py on pooled frames,
                                     or given boxes (simple_detect.py role)
  2. square crop x1.05 + resize   -- ops/crop.py (data_load4.py:110-166)
  3. heatmaps                     -- models/hrnet.py (seg_hrnet3 forward),
                                     or models/vitpose.py at stride 4
  4. peak decode + log-Taylor     -- ops/peak.py -> the CUDA kernel on the card
  5. confidence top-k select      -- demo.py:195-200 / val.py:172-177
  6. RANSAC-EPnP + dual LM refine -- ops/pnp.py
  7. quaternion output            -- demo.py:301-303

Every stage follows the device of its inputs and runs batched with no host
read-back.  Each stage runs inside ``obs/profiling.stage`` (``detect``,
``crop``, ``hrnet``, ``decode``, ``ransac_epnp``, ``refine``): in a CUDA
graph captured by ``utils/graphs`` (:func:`make_jitted_pipeline`) it is a
pair of device stamps that every replay writes into the process's
recorder, so each call's device time per stage is kept with no profiler
running (``obs/profiling.Recorder``); run eagerly it is a
``record_function`` range that a profiler trace shows (on the CPU, inside
a graph's call, host stamps too).
"""

from __future__ import annotations

import inspect
from typing import NamedTuple

import torch

from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.core.camera import rotmat_to_quat
from esa_pose_estimation_tpu_torch.models.detector import decode_detections
from esa_pose_estimation_tpu_torch.obs.profiling import stage
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops
from esa_pose_estimation_tpu_torch.ops import peak as peak_ops
from esa_pose_estimation_tpu_torch.ops import pnp as pnp_mod
from esa_pose_estimation_tpu_torch.parallel import mesh as mesh_mod
from esa_pose_estimation_tpu_torch.utils import graphs


class PoseOutput(NamedTuple):
    quat: torch.Tensor          # (B, 4) (w, x, y, z)
    trans: torch.Tensor         # (B, 3)
    R: torch.Tensor             # (B, 3, 3)
    keypoints_2d: torch.Tensor  # (B, K, 2) full-frame pixel predictions
    confidences: torch.Tensor   # (B, K) heatmap peak values
    selected: torch.Tensor      # (B, K) bool keypoints used for the pose
    heatmaps: torch.Tensor      # (B, S, S, K) network output
    rates: torch.Tensor         # (B,) crop rate (uncrop: pred * stride /
    # rate + origin, stride = crop size / heatmap size)
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
                ransac_masks: torch.Tensor | None = None,
                ransac_uniforms: torch.Tensor | None = None) -> PoseOutput:
    """Batched frames + detector boxes -> poses.

    frames (B, H, W) grayscale [0, 255]; bboxes (B, 4) [x1, y1, x2, y2];
    points_3d (K, 3) model keypoints.  ``model`` is an :class:`HRNet` or a
    :class:`ViTPose` on the frames' device.  ``generator`` draws the RANSAC
    samples (on the frames' device); ``ransac_uniforms`` (B, n_hypotheses,
    K), drawn by ``ops.pnp.draw_ransac_uniforms``, replace that draw, and
    ``ransac_masks`` (B, n_hypotheses, K) inject the samples themselves.
    ``crop_rule``: 'train' = ESADataSet box rule, 'val' = the submission
    rule without square-equalization.
    """
    if crop_rule not in ('train', 'val'):
        raise ValueError(f'unknown crop_rule {crop_rule!r}')
    with stage('crop'):
        crops, rates, origins = crop_ops.crop_resize(
            frames, bboxes, crop_size, img_w=frames.shape[2],
            img_h=frames.shape[1], force_square=crop_rule == 'train')
    return infer_poses_from_crops(
        model, crops, rates, origins, points_3d, generator, K=K,
        conf_threshold=conf_threshold, min_keypoints=min_keypoints,
        n_hypotheses=n_hypotheses, sample_size=sample_size,
        lm_iters=lm_iters, norm_mean=norm_mean, norm_std=norm_std,
        disambiguate=disambiguate, flip_tta=flip_tta,
        mirror_evidence=mirror_evidence, ransac_masks=ransac_masks,
        ransac_uniforms=ransac_uniforms)


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
                           ransac_masks: torch.Tensor | None = None,
                           ransac_uniforms: torch.Tensor | None = None
                           ) -> PoseOutput:
    """The serving tail from cropped imagery: normalize -> network ->
    decode -> select -> uncrop -> RANSAC-EPnP -> dual LM.

    crops (B, S, S) [0, 255]; rates (B,); origins (B, 2), as
    ``ops.crop.crop_resize`` returns them.  The network's heatmaps may be
    smaller than the crop by a stride taken from the shapes (S over the
    heatmaps' side: 1 for HRNet, 4 for ViTPose): a heatmap pixel ``c`` is
    crop pixel ``c * stride`` (mmpose's convention without UDP), so the
    uncrop is ``coords * stride / rates + origins`` and the mirror pose's
    heatmap evidence reprojects at ``rates / stride``.  At stride 1 both
    are the plain ``coords / rates + origins`` and ``rates``.  The network
    stage keeps its name ``hrnet`` whatever the model.
    """
    dev = crops.device
    if K is None:
        K = camera.speed_k(torch.float32, dev)
    points_3d = points_3d.to(device=dev, dtype=torch.float32)
    with stage('hrnet'):
        x = crop_ops.normalize(crops, norm_mean, norm_std)[..., None]
        hm = model(x)                                      # (B, S, S, K)
        if flip_tta:
            # forward the mirrored crop, un-flip its heatmaps, average
            # (SPEED's 30 keypoints have no left/right pairs: the channel
            # swap is the identity)
            hm_f = model(torch.flip(x, dims=(2,)))
            hm = (hm + torch.flip(hm_f, dims=(2,))) * 0.5
    with stage('decode'):
        coords, maxvals = peak_ops.decode_heatmaps_auto_nhwc(hm)
        sel = peak_ops.select_confident(maxvals, conf_threshold,
                                        min_count=min_keypoints)
        stride = _heatmap_stride(crops, hm)
        hm_rates = rates
        if stride != 1:
            coords = coords * stride
            hm_rates = rates / stride
        uncropped = (coords / rates[:, None, None]
                     + origins[:, None, :].to(torch.float32))
    p3 = points_3d.expand((crops.shape[0],) + points_3d.shape)
    with stage('ransac_epnp'):
        init = pnp_mod.ransac_epnp(p3, uncropped, K, generator, valid=sel,
                                   n_hypotheses=n_hypotheses,
                                   sample_size=sample_size,
                                   lm_iters=lm_iters, masks=ransac_masks,
                                   uniforms=ransac_uniforms)
    with stage('refine'):
        # final confidence-weighted refinement over the RANSAC inliers,
        # falling back to the selection when the inlier set is degenerate
        R, t = pnp_mod.refine_pose(
            p3, uncropped, maxvals, K, init.R, init.t, iters=lm_iters,
            disambiguate=disambiguate, select=sel, inliers=init.inliers,
            heatmaps=hm if mirror_evidence == 'heatmap' else None,
            rates=hm_rates, origins=origins)
    return PoseOutput(quat=rotmat_to_quat(R), trans=t, R=R,
                      keypoints_2d=uncropped, confidences=maxvals,
                      selected=sel, heatmaps=hm, rates=rates,
                      origins=origins)


def _heatmap_stride(crops: torch.Tensor, hm: torch.Tensor) -> int:
    """Crop pixels per heatmap pixel, from the shapes: (B, S, S) crops and
    (B, S / stride, S / stride, K) heatmaps."""
    size, side = crops.shape[1], hm.shape[1]
    if size % side or hm.shape[2] != side:
        raise ValueError(f'heatmaps {tuple(hm.shape)} do not tile crops '
                         f'{tuple(crops.shape)} by a whole stride')
    return size // side


def make_pipeline(model, points_3d: torch.Tensor,
                  K: torch.Tensor | None = None, **kwargs):
    """Returns fn(frames, bboxes, generator=None) -> PoseOutput:
    :func:`infer_poses` with the model, the keypoint model and the serving
    keywords bound, run eagerly (a profiler sees its stage ranges, which
    a graph's replay does not emit: there the recorder's stamps time
    them)."""
    def run(frames, bboxes, generator=None):
        return infer_poses(model, frames, bboxes, points_3d, generator, K=K,
                           **kwargs)
    return run


def make_jitted_pipeline(model, points_3d: torch.Tensor,
                         K: torch.Tensor | None = None, **kwargs):
    """Returns fn(frames, bboxes, generator=None, ransac_uniforms=None) ->
    PoseOutput, the JAX ``make_jitted_pipeline``: :func:`infer_poses` with
    the model, the keypoint model and the serving keywords bound, on the
    card as one CUDA graph per input shape (``utils/graphs.Graphed``; on
    CPU tensors it runs eagerly).  The RANSAC uniforms are drawn from
    ``generator`` before the replay, so a call consumes the generator as
    :func:`infer_poses` does and returns the same poses; uniforms drawn
    already (``ops.pnp.draw_ransac_uniforms``) may be passed instead.
    ``fn.graphs`` is the :class:`~utils.graphs.Graphed`."""
    graphed = graphs.Graphed(infer_poses)
    n_hyp = _n_hypotheses(kwargs)

    def run(frames, bboxes, generator=None, ransac_uniforms=None):
        if ransac_uniforms is None and kwargs.get('ransac_masks') is None:
            ransac_uniforms = pnp_mod.draw_ransac_uniforms(
                generator, frames.shape[:1], points_3d.shape[-2], n_hyp,
                frames.device)
        return graphed(model, frames, bboxes, points_3d, K=K,
                       ransac_uniforms=ransac_uniforms, **kwargs)
    run.graphs = graphed
    return run


def _n_hypotheses(kwargs: dict) -> int:
    return kwargs.get('n_hypotheses', inspect.signature(
        infer_poses).parameters['n_hypotheses'].default)


def make_sharded_pipeline(model, points_3d: torch.Tensor, mesh,
                          K: torch.Tensor | None = None, **kwargs):
    """Returns fn(frames, bboxes, generator=None) -> ``parallel.mesh.Sharded``
    of :class:`PoseOutput`, the counterpart of ``jax.jit(infer_poses,
    in_shardings=(rep, dat, dat, rep))`` over the ``data`` axis of
    ``mesh`` (``parallel/mesh.make_mesh``) in one process.

    Each device of the mesh holds its own replica of ``model``
    (``mesh.replicate``, of the serving form as it is now) and its own
    :func:`make_jitted_pipeline`, so one CUDA graph per card and input
    shape.  A call:

    * draws the RANSAC uniforms of the global batch once from
      ``generator`` (on its device, else the mesh's first), as the
      unsharded call draws them, so it consumes the generator as
      :func:`make_jitted_pipeline` does, and copies each card's slice to
      it;
    * copies each card's slice of ``frames`` and ``bboxes`` to it on that
      card's stream (``mesh.shard_batch``: from another card or from
      page-locked host memory the host does not wait);
    * launches every card's replay before any result is waited on.

    Shard k of the result lies on ``mesh.devices[k]`` and holds that
    slice's poses, as JAX's output sharding leaves them;
    ``.gather(device)`` assembles the global batch.  With CPU devices
    each shard runs eagerly, one after another.  ``ransac_masks`` (the
    global batch's, to inject a draw) are sharded once, with the
    replicas."""
    masks = kwargs.pop('ransac_masks', None)
    mask_shards = (mesh_mod.shard_batch(masks, mesh).shards
                   if masks is not None else [None] * len(mesh.devices))
    runs = [make_jitted_pipeline(
        replica, points_3d.to(dev), None if K is None else K.to(dev),
        ransac_masks=m, **kwargs)
        for replica, dev, m in zip(mesh_mod.replicate(model, mesh),
                                   mesh.devices, mask_shards)]
    n_hyp = _n_hypotheses(kwargs)

    def run(frames, bboxes, generator=None):
        uniforms = [None] * len(runs)
        if masks is None:
            dev = (mesh.devices[0] if generator is None
                   else generator.device)
            uniforms = mesh_mod.shard_batch(pnp_mod.draw_ransac_uniforms(
                generator, frames.shape[:1], points_3d.shape[-2], n_hyp,
                dev), mesh).shards
        f = mesh_mod.shard_batch(frames, mesh).shards
        b = mesh_mod.shard_batch(bboxes, mesh).shards
        return mesh_mod.Sharded([
            fn(fk, bk, ransac_uniforms=uk)
            for fn, fk, bk, uk in zip(runs, f, b, uniforms)])
    return run


def downsample_frames(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool (B, H, W) frames by an integer factor (the detector's
    input), as float32.  H and W must divide by ``factor`` (1920x1200
    divides by 2, 4 and 8)."""
    frames = frames.to(torch.float32)     # loaders may ship uint8 frames
    if factor == 1:
        return frames
    b, h, w = frames.shape
    return frames.reshape(b, h // factor, factor,
                          w // factor, factor).mean(dim=(2, 4))


@torch.no_grad()
def detect_frames(detector, frames: torch.Tensor, detector_stride: int = 16,
                  detector_downscale: int = 4, box_expand: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames (B, H, W) -> one full-frame-pixels box (B, 4) per image, and
    its score (B,).

    ``detector`` (a :class:`~models.detector.TinyDetector` on the frames'
    device) runs on ``detector_downscale``x average-pooled frames: the
    spacecraft spans hundreds of pixels, so a quarter-resolution pass keeps
    the localisation while cutting the detector's work 16x.  Falls back to
    the full frame when no box clears the 0.05 score threshold.
    ``box_expand`` grows each box about its center before the frame clip
    (a margin for a tight box; the crop adds the reference's x1.05).
    """
    with stage('detect'):
        ds = downsample_frames(frames, detector_downscale)
        det_out = detector(ds[..., None])
        boxes, scores, valid = decode_detections(det_out, detector_stride,
                                                 max_outputs=1,
                                                 score_threshold=0.05)
        h, w = frames.shape[1], frames.shape[2]
        up = boxes[:, 0, :] * float(detector_downscale)
        if box_expand != 1.0:
            c = (up[:, :2] + up[:, 2:]) / 2.0
            half = (up[:, 2:] - up[:, :2]) / 2.0 * box_expand
            up = torch.cat([c - half, c + half], dim=-1)
        # clip, or the full frame where no box is valid, column by column
        # with Python scalars: a small host tensor copied to the card
        # would make the host wait for the detector's kernels
        hi = (w - 1.0, h - 1.0, w - 1.0, h - 1.0)
        full = (0.0, 0.0, w - 1.0, h - 1.0)
        bboxes = torch.stack(
            [torch.where(valid[:, 0], torch.clamp(up[:, j], 0.0, hi[j]),
                         full[j]) for j in range(4)], dim=-1)
    return bboxes, scores[:, 0]


@torch.no_grad()
def detect_and_infer(detector, model, frames: torch.Tensor,
                     points_3d: torch.Tensor,
                     generator: torch.Generator | None = None,
                     detector_stride: int = 16, detector_downscale: int = 4,
                     **kwargs) -> PoseOutput:
    """Two-stage pipeline, the on-device detector supplying the boxes
    (reference BASELINE config 3: detect -> crop -> keypoint).  ``kwargs``
    go to :func:`infer_poses`."""
    bboxes, _ = detect_frames(detector, frames, detector_stride,
                              detector_downscale)
    return infer_poses(model, frames, bboxes, points_3d, generator,
                       **kwargs)
