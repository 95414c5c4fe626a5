"""Detector training command: gives the two-stage pipeline a trained box
stage (port of the JAX package's ``cli/train_detector.py``).

    python -m esa_pose_estimation_tpu_torch.cli.train_detector \\
        --workdir runs/det [--epochs 6] [--steps-per-epoch 50] \\
        [--batch-size 16] [--downscale 4] [--augment] [--device cpu]

The reference took its boxes from a COCO-pretrained YOLOv5s run offline
(simple_detect.py:5-19, the boxes stored in the dataset pickles,
data_load4.py:110).  The port trains its own ``TinyDetector``
(``models/detector.py``) on synthetic SPEED-like frames rendered on the
device, in float32, and reports the top box's IoU against the truth on
held-out frames, clean and through the capture perturbations
(``data/augment.perturb_capture``), every epoch.  ``--augment`` trains
through those perturbations: the substitute for COCO pretraining that the
JAX package's round-5 detector used (``--downscale 8 --epochs 16
--augment``).

The detector sees ``downscale``x average-pooled frames, exactly what
``pipeline.detect_frames`` feeds it when serving.  The run writes
``detector.json`` (the geometry the weights are trained for, which
``cli/eval_synthetic --detector-workdir`` reads back), rolling ``last``
and metric-gated ``best_iou`` checkpoints under ``net_detector/``
(``train/checkpoint.py``), ``log_detector.txt`` and ``events.jsonl``.  A
run resumes from ``last``.

Each step (the frames perturbed, pooled, the targets, forward, backward,
Adam) runs through ``train/state.make_train_steps``: on the card one CUDA
graph replay per step.  Runs on the card (``--device cuda``, the default;
without one it raises) or on the CPU with ``--device cpu``.  The random
streams are torch's,
seeded from ``--seed``: the frames are not the JAX run's.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from esa_pose_estimation_tpu_torch.data import augment, synthetic
from esa_pose_estimation_tpu_torch.models import detector as det_mod
from esa_pose_estimation_tpu_torch.obs import JsonlLogger, TsvLogger
from esa_pose_estimation_tpu_torch.ops.nms import iou_matrix
from esa_pose_estimation_tpu_torch.pipeline import (
    detect_frames,
    downsample_frames,
)
from esa_pose_estimation_tpu_torch.train import state as state_mod
from esa_pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from esa_pose_estimation_tpu_torch.utils.artifact import target_device
from esa_pose_estimation_tpu_torch.utils.seeding import generator

BEST = 'best_iou'


def make_frame_batch(generator: torch.Generator | None, batch_size: int,
                     points_3d: torch.Tensor, height: int, width: int,
                     draws: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames (B, H, W) [0, 255], boxes (B, 4) full-frame pixels) of
    random poses, on ``points_3d``'s device.  ``draws`` ({'quat', 'trans'},
    as ``synthetic.random_pose`` draws them) replaces the generator's."""
    if draws is None:
        q, t = synthetic.random_pose(generator, batch_size,
                                     device=points_3d.device)
    else:
        q, t = draws['quat'], draws['trans']
    s = synthetic.sample_from_pose(q, t, points_3d, height, width)
    return s.image, s.bbox


def perturb_frames(generator: torch.Generator | None, frames: torch.Tensor,
                   draws: dict | None = None) -> torch.Tensor:
    """The capture-condition perturbations of the detector's robustness
    training and probe: a per-frame exposure shift (gain, offset), then the
    gaussian-noise-or-motion-blur coin of the reference's augmentation
    library (``augment.perturb_capture``, augmentation.py:207-233).  A
    from-scratch detector trained on clean frames alone collapses under
    noise, blur and exposure shifts.  ``draws`` (``augment.draw_perturb``)
    replaces the generator's."""
    if draws is None:
        draws = augment.draw_perturb(generator, *frames.shape,
                                     device=frames.device)
    return augment.perturb_capture(frames, draws)


def create_detector_state(model: torch.nn.Module, lr: float,
                          total_steps: int = 0) -> state_mod.TrainState:
    """Adam (optax's defaults) over ``model``'s parameters, which must
    already be on their device.  ``total_steps > 0`` decays the rate along
    a cosine to lr/100 (a constant rate plateaus, then oscillates; the
    decay holds the late-epoch IoU); 0 keeps it constant."""
    schedule = state_mod.cosine_schedule(lr, total_steps, alpha=0.01)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=(0.9, 0.999), eps=1e-8)
    return state_mod.TrainState(model, opt, schedule)


def grid_hw(height: int, width: int, stride: int) -> tuple[int, int]:
    """The detector's output grid for (height, width) inputs: each of its
    stride-2 convs pads k//2 and gives ceil(in / 2) cells, as the JAX
    model's SAME-padded ones do, so the grid is ceil(in / stride)."""
    return -(-height // stride), -(-width // stride)


def step_inputs(frames: torch.Tensor, bboxes: torch.Tensor,
                perturb: torch.Generator | None = None) -> dict:
    """One step's inputs: the frames and boxes, and with a ``perturb``
    generator the draws of :func:`perturb_frames`, drawn here, before the
    step."""
    inputs = {'frames': frames, 'bboxes': bboxes}
    if perturb is not None:
        inputs['perturb'] = augment.draw_perturb(perturb, *frames.shape,
                                                 device=frames.device)
    return inputs


def step_loss(model: torch.nn.Module, inputs: dict, stride: int,
              downscale: int) -> torch.Tensor:
    """The step as ``train/state.make_train_steps`` holds it (the JAX
    package jits it with :func:`perturb_frames`): the frames through their
    perturbation draws (``inputs['perturb']``, when there are any), pooled
    by ``downscale``, the boxes scaled to match, the targets on the
    detector's grid, a train-mode forward (batch statistics) and
    :func:`models.detector.detection_loss`."""
    frames = inputs['frames']
    if 'perturb' in inputs:
        frames = perturb_frames(None, frames, inputs['perturb'])
    ds = downsample_frames(frames, downscale)
    targets = det_mod.detection_targets(
        inputs['bboxes'] / float(downscale),
        grid_hw(ds.shape[1], ds.shape[2], stride), stride)
    return det_mod.detection_loss(model(ds[..., None]), targets)


def train_step(state: state_mod.TrainState, frames: torch.Tensor,
               bboxes: torch.Tensor, stride: int, downscale: int
               ) -> dict[str, torch.Tensor]:
    """One eager step on full frames (B, H, W) and their boxes (B, 4):
    :func:`step_loss`, its backward and Adam.  Returns the loss and the
    gradients' global norm as device tensors: no host sync."""
    return state_mod.optimize(state, lambda model: step_loss(
        model, {'frames': frames, 'bboxes': bboxes}, stride, downscale))


def held_out_batches(points_3d: torch.Tensor, seed: int, n_batches: int,
                     batch_size: int, height: int, width: int,
                     perturb: bool = False
                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The fixed held-out frames and their true boxes, ``n_batches`` of
    ``batch_size``; with ``perturb`` the same frames through
    :func:`perturb_frames`."""
    dev = points_3d.device
    out = []
    for i in range(n_batches):
        frames, gt = make_frame_batch(generator(dev, seed, 999_999, i),
                                      batch_size, points_3d, height, width)
        if perturb:
            frames = perturb_frames(generator(dev, seed, 999_999, 5000 + i),
                                    frames)
        out.append((frames, gt))
    return out


@torch.no_grad()
def evaluate_detector(model, batches, stride: int, downscale: int
                      ) -> dict[str, float]:
    """Mean IoU of the top box against the truth over ``batches`` of
    (frames, boxes), and the share of frames above IoU 0.5 and 0.75
    (``pipeline.detect_frames``, eval mode)."""
    model.eval()
    ious = []
    for frames, gt in batches:
        pred, _ = detect_frames(model, frames, stride, downscale)
        ious.append(iou_matrix(pred[:, None], gt[:, None])[:, 0, 0])
    iou = torch.cat(ious).cpu()
    return {'mean_iou': float(iou.mean()),
            'detect_rate_50': float((iou > 0.5).float().mean()),
            'detect_rate_75': float((iou > 0.75).float().mean())}


def train(args) -> dict:
    dev = target_device(args.device, 'cli.train_detector')
    os.makedirs(args.workdir, exist_ok=True)
    model = det_mod.TinyDetector(width=args.width_ch, stride=args.stride).to(
        device=dev, memory_format=torch.channels_last)
    model.init_weights(generator(dev, args.seed))
    # the input geometry the weights are trained for: its consumers read
    # it back, so the downscale cannot silently mismatch
    det_mod.save_detector_config(
        args.workdir, downscale=args.downscale, stride=args.stride,
        width_ch=args.width_ch, height=args.height, width=args.width)
    points_3d = synthetic.spacecraft_points(device=dev, n=args.num_keypoints)
    state = create_detector_state(
        model, args.lr, total_steps=args.epochs * args.steps_per_epoch)
    ckpt = CheckpointManager(os.path.join(args.workdir, 'net_detector'))
    state, begin_epoch = ckpt.restore('last', state)
    # the best IoU so far survives a resume (sidecar), so a restarted run
    # cannot replace best_iou with worse weights
    best = ckpt.load_best()

    logger = TsvLogger(os.path.join(args.workdir, 'log_detector.txt'),
                       resume=True)
    logger.set_names(['Epoch', 'LR', 'Train Loss', 'Mean IoU'])
    events = JsonlLogger(os.path.join(args.workdir, 'events.jsonl'))
    held_out = {
        key: held_out_batches(points_3d, args.seed, args.eval_batches,
                              args.batch_size, args.height, args.width,
                              perturb=key == 'perturbed')
        for key in ('clean', 'perturbed')}
    result: dict = {}
    # the JAX package's jitted step: on the card one CUDA graph replay per
    # step, with the frames, boxes and perturbation draws copied in and the
    # cosine rate written into a device tensor
    step = state_mod.make_train_steps(state, lambda model, x: step_loss(
        model, x, args.stride, args.downscale))
    try:
        for epoch in range(begin_epoch, args.epochs):
            t0 = time.perf_counter()
            losses = []
            for i in range(args.steps_per_epoch):
                frames, bboxes = make_frame_batch(
                    generator(dev, args.seed, 1, epoch, i), args.batch_size,
                    points_3d, args.height, args.width)
                losses.append(step([step_inputs(
                    frames, bboxes, generator(dev, args.seed, 2, epoch, i)
                    if args.augment else None)]))
            loss_avg = float(torch.cat(losses).mean())     # waits for the card
            train_s = time.perf_counter() - t0
            result = evaluate_detector(model, held_out['clean'], args.stride,
                                       args.downscale)
            pert = evaluate_detector(model, held_out['perturbed'],
                                     args.stride, args.downscale)
            result.update({f'perturbed_{k}': v for k, v in pert.items()})
            logger.append([epoch + 1, args.lr, loss_avg,
                           result['mean_iou']])
            events.log('epoch', epoch=epoch + 1, loss=loss_avg,
                       seconds=time.perf_counter() - t0, train_seconds=train_s,
                       **result)
            ckpt.save_rolling(state, epoch)
            if result['mean_iou'] > best.get(BEST, -1.0):
                # the sidecar first, as save_rolling orders its gates
                best[BEST] = result['mean_iou']
                ckpt.store_best(best)
                ckpt.save(BEST, state, epoch)
            print(f"detector epoch {epoch + 1}: loss {loss_avg:.4f}  "
                  f"IoU {result['mean_iou']:.3f}  "
                  f"rate@.5 {result['detect_rate_50']:.3f}  "
                  f"perturbed IoU {result['perturbed_mean_iou']:.3f}  "
                  f"rate@.5 {result['perturbed_detect_rate_50']:.3f}  "
                  f"({train_s:.1f} s of training)")
    finally:
        logger.close()
        events.close()
    return result


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workdir', default='runs/detector')
    ap.add_argument('--epochs', type=int, default=6)
    ap.add_argument('--steps-per-epoch', type=int, default=50)
    ap.add_argument('--batch-size', type=int, default=16)
    ap.add_argument('--height', type=int, default=1200)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--downscale', type=int, default=4)
    ap.add_argument('--stride', type=int, default=16)
    ap.add_argument('--width-ch', type=int, default=32)
    ap.add_argument('--num-keypoints', type=int, default=30)
    ap.add_argument('--eval-batches', type=int, default=4)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--augment', action='store_true',
                    help='train through capture-condition perturbations '
                         '(gaussian noise or motion blur, exposure shift): '
                         'the substitute for COCO pretraining in detector '
                         'robustness; every epoch also reports the '
                         'perturbed IoU and detection rates')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default; without a card it "
                         "raises) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    return train(_parser().parse_args(argv))


if __name__ == '__main__':
    main()
