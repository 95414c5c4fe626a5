"""Held-out synthetic SPEED evaluation with per-frame score statistics.

    python -m esa_pose_estimation_tpu_torch.cli.eval_synthetic \\
        [--workdir runs/esa_syn --checkpoint best_rotate | \\
         --artifact artifacts/esa_syn_r5.npz] [--perturb] \\
        [--detector-workdir runs/det [--detector-downscale 8]] \\
        [--device cpu]

Port of the JAX package's ``cli/eval_synthetic.py``.  It scores ``--frames``
synthetic frames through the full serving path
(``pipeline.make_jitted_pipeline``: on the card one CUDA graph, replayed
per batch) and prints one JSON line: median / p90 / mean SPEED score, the
fraction of frames beating the reference leaderboard score (0.0193), the
worst frame and its depth, and the mean pixel error of the selected
keypoints.  ``--perturb`` scores the frames through
``data/augment.perturb_capture`` (exposure gain/offset, then gaussian noise
or motion blur) applied to the full frames before the crop: the capture
condition that ``cli/train --augment-photo`` trains through.

The frames come from ``data/synthetic.make_sample`` with a generator seeded
from ``--seed`` and the batch index, so the frame set is not the JAX one:
scores compare with the JAX package's in distribution, not frame by frame.
The weights come from the port checkpoint ``<workdir>/net_esa/<checkpoint>``
(``cli/train.py`` writes them), or from ``--artifact`` when one is given.

``--detector-workdir`` scores the two-stage chain: the boxes come from the
trained detector of ``cli/train_detector`` (its ``net_detector/best_iou``
checkpoint, which must exist: random detector weights would print bad
scores with exit code 0) in place of the truth, grown by 1.1 about their
centres, at the downscale its ``detector.json`` records
(``--detector-downscale`` overrides it; 4 if neither says).  The stages
are those of ``pipeline.detect_and_infer``, run one after the other so
the record can count the frames whose box fell back to the full frame
(``detector_fallback_frames``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

REFERENCE_SCORE = 0.0193      # the reference's leaderboard score


def summarize(scores: np.ndarray, depths: np.ndarray, pix_err_sum: float,
              pix_err_n: int) -> dict:
    """The JSON record of per-frame scores and depths.  Non-finite frames
    (solver divergence) are counted and left out of every statistic; if
    none is finite the statistics are null."""
    finite = np.isfinite(scores)
    n_nonfinite = int((~finite).sum())
    scores, depths = scores[finite], depths[finite]
    pix = round(pix_err_sum / max(pix_err_n, 1), 3)
    if scores.size == 0:
        return {
            'frames': 0, 'nonfinite_frames': n_nonfinite,
            'median': None, 'p90': None, 'mean': None,
            'beat_reference_frac': None, 'worst': None,
            'worst_depth_m': None, 'pix_err_px': pix,
            'error': 'every frame produced a non-finite pose',
        }
    return {
        'frames': int(len(scores)),
        'nonfinite_frames': n_nonfinite,
        'median': round(float(np.median(scores)), 4),
        'p90': round(float(np.percentile(scores, 90)), 4),
        'mean': round(float(scores.mean()), 4),
        'beat_reference_frac': round(
            float((scores < REFERENCE_SCORE).mean()), 3),
        'worst': round(float(scores.max()), 3),
        'worst_depth_m': round(float(depths[scores.argmax()]), 1),
        'pix_err_px': pix,
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workdir', default='runs/esa_syn',
                    help='the training run whose net_esa/ checkpoint is '
                         'scored')
    ap.add_argument('--checkpoint', default='best_rotate',
                    help='checkpoint name under <workdir>/net_esa')
    ap.add_argument('--artifact', default=None,
                    help='inference artifact (.npz) to evaluate in place of '
                         'the checkpoint, e.g. artifacts/esa_syn_r5.npz')
    ap.add_argument('--frames', type=int, default=128)
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--seed', type=int, default=991)
    ap.add_argument('--n-hypotheses', type=int, default=64)
    ap.add_argument('--tiny', action='store_true',
                    help='tiny model topology (must match the weights)')
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--flip-tta', action='store_true',
                    help='average heatmaps with a mirrored-input forward '
                         'pass; 2x forward cost')
    ap.add_argument('--perturb', action='store_true',
                    help='score the frames through capture-condition '
                         'perturbations (per-frame exposure gain/offset, '
                         'then gaussian noise or motion blur, '
                         'data/augment.perturb_capture) applied to the full '
                         'frame before the crop')
    ap.add_argument('--detector-workdir', default=None,
                    help='score the two-stage pipeline: the boxes come '
                         'from the detector trained in this workdir '
                         '(cli.train_detector) instead of the truth')
    ap.add_argument('--detector-downscale', type=int, default=None,
                    help='average-pool factor of the detector input '
                         '(default: the detector.json of its run, else 4)')
    ap.add_argument('--mirror-evidence', choices=('heatmap', 'cost'),
                    default='heatmap',
                    help='mirror-pose disambiguation signal: reprojected-'
                         'keypoint heatmap likelihood or LM cost alone')
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from esa_pose_estimation_tpu_torch import pipeline
    from esa_pose_estimation_tpu_torch.data import augment, synthetic
    from esa_pose_estimation_tpu_torch.eval.speed_score import (
        speed_score_from_matrices,
    )
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        load_cli_artifact,
        load_cli_checkpoint,
    )
    from esa_pose_estimation_tpu_torch.utils.seeding import generator

    dev = torch.device(args.device)
    if args.artifact:
        model, meta = load_cli_artifact(args.artifact, args.tiny,
                                        args.crop_size, dev)
        print(f'# loaded artifact {args.artifact} ({meta})')
    else:
        model, epoch = load_cli_checkpoint(args.workdir, args.checkpoint,
                                           args.tiny, dev)
        print(f'# loaded {args.checkpoint} (epoch {epoch})')
    points_3d = synthetic.spacecraft_points(
        device=dev, n=model.cfg.num_keypoints)
    detector = (load_trained_detector(args.detector_workdir,
                                      args.detector_downscale, dev)
                if args.detector_workdir else None)

    all_scores, depths = [], []
    n_fallback = 0
    pix_err_sum, pix_err_n = 0.0, 0
    n_batches = -(-args.frames // args.batch_size)
    serve = pipeline.make_jitted_pipeline(
        model, points_3d, crop_size=args.crop_size, conf_threshold=0.6,
        min_keypoints=0, n_hypotheses=args.n_hypotheses,
        flip_tta=args.flip_tta, mirror_evidence=args.mirror_evidence)
    for i in range(n_batches):
        gen = torch.Generator(device=dev).manual_seed(args.seed * 100_003 + i)
        s = synthetic.make_sample(gen, points_3d, args.batch_size)
        frames = s.image
        if args.perturb:
            frames = augment.perturb_capture(frames, augment.draw_perturb(
                generator(dev, args.seed, i, 4242), *frames.shape,
                device=dev))
        boxes = s.bbox
        if detector is not None:
            det, ds = detector
            boxes, det_scores = pipeline.detect_frames(
                det, frames, det.stride, ds, box_expand=1.1)
            # detect_frames serves the full frame where no box
            # scored above 0.05 (its score is then 0)
            take = min(args.batch_size, args.frames - i * args.batch_size)
            n_fallback += int((det_scores <= 0.05)[:take].sum())
        out = serve(frames, boxes, gen)
        sc = speed_score_from_matrices(out.R, out.trans, s.quat, s.trans)
        all_scores.append((sc.score_t + sc.score_r).cpu().numpy())
        depths.append(s.trans[:, 2].cpu().numpy())
        # pixel error over the confidence-selected peaks, on exactly
        # the --frames frames every other statistic covers
        take = min(args.batch_size, args.frames - i * args.batch_size)
        err = torch.linalg.vector_norm(out.keypoints_2d - s.keypoints_2d,
                                       dim=-1)
        m = out.selected
        pix_err_sum += float((err * m)[:take].sum())
        pix_err_n += int(m[:take].sum())
    record = summarize(np.concatenate(all_scores)[:args.frames],
                       np.concatenate(depths)[:args.frames],
                       pix_err_sum, pix_err_n)
    if detector is not None:
        record['detector_fallback_frames'] = n_fallback
    print(json.dumps(record))
    return record


def load_trained_detector(workdir: str, downscale: int | None, device):
    """The ``best_iou`` detector of a ``cli.train_detector`` run in eval
    mode on ``device``, and the downscale it serves at; a missing
    checkpoint raises, listing the names there."""
    from esa_pose_estimation_tpu_torch.models.detector import (
        TinyDetector,
        load_detector_config,
    )
    from esa_pose_estimation_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from esa_pose_estimation_tpu_torch.train.state import TrainState
    from esa_pose_estimation_tpu_torch.utils.artifact import target_device

    device = target_device(device, 'load_trained_detector')
    cfg = load_detector_config(workdir) or {}
    det = TinyDetector(width=cfg.get('width_ch', 32),
                       stride=cfg.get('stride', 16)).to(
        device=device, memory_format=torch.channels_last)
    _, next_epoch = CheckpointManager(
        os.path.join(workdir, 'net_detector')).restore_required(
        'best_iou', TrainState(det))
    print(f'# loaded detector {workdir} best_iou (epoch {next_epoch - 1})')
    return det.eval(), downscale or cfg.get('downscale', 4)


if __name__ == '__main__':
    main()
