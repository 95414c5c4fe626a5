"""Device-side input pipeline: raw frames + boxes -> model-ready batches
(torch port of the JAX package's ``data/pipeline.py``).

The batched equivalent of ``ESADataSet.__getitem__`` (data_load4.py:103-203):
square crop x1.05 -> resize -> keypoints to crop space -> Gaussian heatmap +
weight targets -> color jitter (train) -> normalize, on the device for the
whole batch.  Random draws come from ``draw_build`` (or are injected as
``draws``), as in ``data/augment.py``.  :func:`prefetch_to_device` keeps
host batches' copies to the card in flight ahead of the consumer;
:func:`build_shard_batch` turns a native-loader batch
(``data/native_loader.py``), frames or host crops, into a training batch;
:func:`step_inputs` and :func:`step_loss` are the two halves of that build
and its train step as one captured program.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from esa_pose_estimation_tpu_torch.data import augment
from esa_pose_estimation_tpu_torch.data.speed import to_device
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops
from esa_pose_estimation_tpu_torch.ops import heatmap as heatmap_ops
from esa_pose_estimation_tpu_torch.train.loss import weighted_heatmap_loss


def draw_crop_geom(generator: torch.Generator, batch: int,
                   max_deg: float = 25.0, device=None) -> dict:
    """:func:`augment_crop_geom`'s draws: a flip coin (p 0.5) and an angle
    in [-max_deg, max_deg) degrees per sample."""
    return {'flip': torch.rand((batch,), generator=generator,
                               device=device) < 0.5,
            'angle': -max_deg + 2.0 * max_deg * torch.rand(
                (batch,), generator=generator, device=device)}


def augment_crop_geom(crops: torch.Tensor, kp_crop: torch.Tensor,
                      draws: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Train-time geometric augmentation of crop-space imagery (B, S, S)
    [0, 255] and keypoints (B, K, 2): a horizontal flip (an exact slice)
    and an in-plane rotation about the crop centre (bilinear
    ``augment.affine_sample``).  Real imagery exists only after the crop,
    so the rotation resamples pixels and stays within +-25 degrees; the
    synthetic route rotates its keypoints before rendering instead."""
    b, s = crops.shape[0], crops.shape[-1]
    do = draws['flip']
    crops = torch.where(do[:, None, None], torch.flip(crops, dims=(2,)),
                        crops)
    kp_flip = torch.stack([(s - 1) - kp_crop[..., 0], kp_crop[..., 1]], -1)
    kp_crop = torch.where(do[:, None, None], kp_flip, kp_crop)
    ang = draws['angle']
    centers = torch.full((b, 2), (s - 1) / 2.0, dtype=torch.float32,
                         device=crops.device)
    crops = augment.affine_sample(crops,
                                  augment.rotation_matrices(ang, centers))
    th = torch.deg2rad(ang)
    c, sn = torch.cos(th)[:, None], torch.sin(th)[:, None]
    rel = kp_crop - centers[:, None, :]
    kp_crop = torch.stack([c * rel[..., 0] - sn * rel[..., 1],
                           sn * rel[..., 0] + c * rel[..., 1]],
                          dim=-1) + centers[:, None, :]
    return crops, kp_crop


def draw_build(generator: torch.Generator, batch: int, crop_size: int,
               train: bool = True, augment_geom: bool = False,
               augment_photo: bool = False, device=None) -> dict:
    """The draws of one :func:`build_batch` / :func:`build_batch_from_crops`
    call: ``geom`` (with ``augment_geom``), ``photo`` (with
    ``augment_photo``) and ``jitter``, each only under ``train``."""
    draws: dict = {}
    if train and augment_geom:
        draws['geom'] = draw_crop_geom(generator, batch, device=device)
    if train and augment_photo:
        draws['photo'] = augment.draw_perturb(generator, batch, crop_size,
                                              crop_size, device=device)
    if train:
        draws['jitter'] = augment.draw_color_jitter(generator, batch,
                                                    device=device)
    return draws


def _targets(crops, kp_crop, rates, origins, s, sigma, train, norm_mean,
             norm_std, augment_geom, augment_photo, draws):
    if train and augment_geom:
        crops, kp_crop = augment_crop_geom(crops, kp_crop, draws['geom'])
    hm, wm = heatmap_ops.render_targets(kp_crop, s, s, sigma)
    if train and augment_photo:
        crops = augment.perturb_capture(crops, draws['photo'])
    if train:
        crops = augment.color_jitter(crops, draws['jitter'])
    return {
        'image': crop_ops.normalize(crops, norm_mean, norm_std)[..., None],
        'heatmaps': hm.permute(0, 2, 3, 1),
        'weights': wm.permute(0, 2, 3, 1),
        'rate': rates,
        'origin': origins,
        'keypoints_crop': kp_crop,
    }


def build_batch(frames: torch.Tensor, bboxes: torch.Tensor,
                keypoints_2d: torch.Tensor,
                generator: torch.Generator | None = None,
                crop_size: int = 128, sigma: float = 2.0, train: bool = True,
                norm_mean: float = 0.449, norm_std: float = 0.229,
                augment_geom: bool = False, augment_photo: bool = False,
                draws: dict | None = None) -> dict[str, torch.Tensor]:
    """frames (B, H, W) [0, 255]; bboxes (B, 4); keypoints_2d (B, K, 2)
    full-frame -> {'image', 'heatmaps', 'weights', 'rate', 'origin',
    'keypoints_crop'} (NHWC), on the frames' device.

    ``norm_mean/std``: 0.449/0.229 for the synthetic split
    (data_load4.py:81), 0.5/0.229 for the mixed train + real_test split
    (data_load5.py:80-88).  ``draws`` (from :func:`draw_build`) replaces
    the generator's draws.
    """
    if draws is None:
        draws = draw_build(generator, frames.shape[0], crop_size, train,
                           augment_geom, augment_photo, device=frames.device)
    # the box rule clamps to the SPEED frame (1920x1200), as the JAX
    # package's build_batch does whatever the frames' size
    crops, rates, origins = crop_ops.crop_resize(frames, bboxes, crop_size)
    kp_crop = (keypoints_2d - origins[:, None, :].to(torch.float32)
               ) * rates[:, None, None]
    return _targets(crops, kp_crop, rates, origins, crop_size, sigma, train,
                    norm_mean, norm_std, augment_geom, augment_photo, draws)


def build_batch_from_crops(crops: torch.Tensor, rates: torch.Tensor,
                           origins: torch.Tensor, keypoints_2d: torch.Tensor,
                           generator: torch.Generator | None = None,
                           sigma: float = 2.0, train: bool = True,
                           norm_mean: float = 0.449, norm_std: float = 0.229,
                           augment_geom: bool = False,
                           augment_photo: bool = False,
                           draws: dict | None = None
                           ) -> dict[str, torch.Tensor]:
    """Target build for batches cropped on the host: crops (B, S, S)
    [0, 255]; rates (B,); origins (B, 2); keypoints_2d (B, K, 2) full-frame.
    The device renders the targets, jitters and normalizes."""
    s = crops.shape[-1]
    if draws is None:
        draws = draw_build(generator, crops.shape[0], s, train, augment_geom,
                           augment_photo, device=crops.device)
    kp_crop = (keypoints_2d - origins[:, None, :].to(torch.float32)
               ) * rates[:, None, None]
    return _targets(crops, kp_crop, rates, origins, s, sigma, train,
                    norm_mean, norm_std, augment_geom, augment_photo, draws)


def build_shard_batch(b: dict[str, Any],
                      generator: torch.Generator | None = None,
                      crop_size: int = 128, train: bool = True,
                      norm_mean: float = 0.449, augment_geom: bool = False,
                      augment_photo: bool = False, draws: dict | None = None
                      ) -> dict[str, torch.Tensor]:
    """A native-loader batch already on the device -> the model-ready batch:
    :func:`build_batch_from_crops` when the loader cropped on the host
    ('crop', 'rate', 'origin'), else :func:`build_batch` on its uint8
    frames."""
    kw = dict(train=train, norm_mean=norm_mean, augment_geom=augment_geom,
              augment_photo=augment_photo, draws=draws)
    if 'crop' in b:
        return build_batch_from_crops(b['crop'], b['rate'], b['origin'],
                                      b['keypoints_2d'], generator, **kw)
    return build_batch(b['frame'], b['bbox'], b['keypoints_2d'], generator,
                       crop_size=crop_size, **kw)


# the tensors of a loader's batch that build_shard_batch reads: host crops
# or frames, and the labels
STEP_KEYS = ('crop', 'rate', 'origin', 'frame', 'bbox', 'keypoints_2d')


def step_inputs(b: dict[str, Any], generator: torch.Generator,
                crop_size: int = 128, augment_geom: bool = False,
                augment_photo: bool = False) -> dict:
    """One train step's inputs from a loader batch already on the device:
    the tensors :func:`build_shard_batch` reads (``STEP_KEYS``), and its
    draws (:func:`draw_build`), drawn here, before the step, as the per-step
    build drew them.  :func:`step_loss` makes the batch from them, so a
    captured step draws nothing."""
    batch = {k: b[k] for k in STEP_KEYS if k in b}
    n = batch['keypoints_2d'].shape[0]
    return {'batch': batch,
            'draws': draw_build(generator, n, crop_size, True, augment_geom,
                                augment_photo,
                                device=batch['keypoints_2d'].device)}


def step_loss(model, inputs: dict, crop_size: int = 128,
              norm_mean: float = 0.449, augment_geom: bool = False,
              augment_photo: bool = False, loss_w: float = 10.0
              ) -> torch.Tensor:
    """The shard and pickle routes' step as ``train/state.make_train_steps``
    holds it (the JAX package jits ``build_batch`` with its train step):
    :func:`build_shard_batch` on :func:`step_inputs`, the train-mode
    forward and the weighted heatmap loss."""
    batch = build_shard_batch(inputs['batch'], crop_size=crop_size,
                              train=True, norm_mean=norm_mean,
                              augment_geom=augment_geom,
                              augment_photo=augment_photo,
                              draws=inputs['draws'])
    return weighted_heatmap_loss(model(batch['image']), batch['heatmaps'],
                                 batch['weights'], W=loss_w)


def prefetch_to_device(batches: Iterable[dict[str, Any]], device,
                       size: int = 2) -> Iterator[dict[str, Any]]:
    """Keep ``size`` batches' host-to-device copies in flight ahead of the
    consumer.  Each numpy entry goes through page-locked memory, and each
    CPU tensor (the native loader's are page-locked already) is copied
    as it is, without blocking the host (``data.speed.to_device``), so
    batch j+1's copies overlap the device's work on batch j, the role of
    DataLoader prefetching and ``.cuda(non_blocking=True)`` in the
    reference (main.py:273).  Other entries (the 'name' list) pass
    through."""
    buf: collections.deque = collections.deque()
    it = iter(batches)

    def stage(b: dict[str, Any]) -> dict[str, Any]:
        return {k: (to_device(v, device)
                    if isinstance(v, (np.ndarray, torch.Tensor)) else v)
                for k, v in b.items()}

    for b in it:
        buf.append(stage(b))
        if len(buf) == size:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(stage(nxt))
        yield out
