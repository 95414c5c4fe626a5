"""Labelled evaluation command: the reference ``demo.py`` as a command.

    python -m esa_pose_estimation_tpu_torch.cli.evaluate --workdir runs/esa \\
        --test-pkl data/test.pkl --image-root /data/speed/images/train/ \\
        [--checkpoint best_rotate | --artifact artifacts/esa_syn_r5.npz] \\
        [--device cpu]

Port of the JAX package's ``cli/evaluate.py``.  It runs the batched
serving tail over a labelled split (crops cached once on the device by
``eval/eval_cache.EvalCache``, whose tail replays a CUDA graph per batch
shape on the card), reports the SPEED scores (translation,
rotation, combined), the pixel error of the selected keypoints and the
count of frames whose pose came out non-finite, and appends a row to
``<workdir>/load/load_esa.txt`` as the reference does (demo.py:358-363).

:func:`evaluate` is the loop that the JAX package keeps in
``cli/train.py``; here it lives in this module, and the port's
``cli/train.py`` imports it from here.  The weights come from the port
checkpoint ``<workdir>/net_esa/<--checkpoint>`` (``cli/train.py`` writes
them), or from ``--artifact`` (an inference npz) when one is given; a
missing checkpoint raises with the names that are there.  Reading image
files needs Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from esa_pose_estimation_tpu_torch.data import speed as speed_data
from esa_pose_estimation_tpu_torch.data.speed import to_device
from esa_pose_estimation_tpu_torch.eval.eval_cache import EvalCache
from esa_pose_estimation_tpu_torch.eval.evaluator import AverageMeter
from esa_pose_estimation_tpu_torch.eval.speed_score import (
    speed_score_from_matrices,
)
from esa_pose_estimation_tpu_torch.pipeline import infer_poses
from esa_pose_estimation_tpu_torch.utils.artifact import (
    load_cli_artifact,
    load_cli_checkpoint,
)


def load_weights(args, dev):
    """The commands' weights: ``--artifact`` when given, else the port
    checkpoint ``<workdir>/net_esa/<checkpoint>``.  Returns the serving
    model and the name that the results record."""
    if args.artifact:
        model, meta = load_cli_artifact(args.artifact, args.tiny,
                                        args.crop_size, dev)
        print(f'loaded artifact {args.artifact} ({meta})')
        return model, os.path.basename(args.artifact)
    model, epoch = load_cli_checkpoint(args.workdir, args.checkpoint,
                                       args.tiny, dev)
    print(f'loaded checkpoint {args.checkpoint} (epoch {epoch})')
    return model, args.checkpoint


N_PANELS = 4     # the frames an EvalCache keeps on the host by default


def evaluate(model, eval_batches, points_3d,
             generator: torch.Generator | None = None,
             crop_size: int = 128, norm_mean: float = 0.449,
             norm_std: float = 0.229, panel_dir: str | None = None
             ) -> dict:
    """SPEED-score evaluation loop (demo.py:79-369 parity, batched).

    ``eval_batches`` is an :class:`EvalCache` (crops resident on the
    device; only the serving tail runs) or an iterable of frame-carrying
    host batches (cropped and inferred every call).  ``generator`` draws
    the RANSAC samples of every batch in turn.  Frames whose pose is
    non-finite are counted under ``nonfinite`` and left out of the means;
    if none is finite, the scores are ``inf``.

    ``panel_dir``: the first ``N_PANELS`` frames of the first batch are
    drawn there as PNGs (``obs/visual.save_eval_panel``: frame, predicted
    and true keypoints, box, heatmap composite; needs matplotlib), and the
    result names the directory under ``panel_dir``.  An ``EvalCache``
    keeps those frames and boxes on the host.
    """
    cache = eval_batches if isinstance(eval_batches, EvalCache) else None
    dev = next(model.parameters()).device
    score_t = AverageMeter()
    score_r = AverageMeter()
    pix_err = AverageMeter()
    n_bad = 0
    for i, batch in enumerate(cache.batches if cache else eval_batches):
        if cache:
            out = cache.infer(model, batch, generator)
        else:
            out = infer_poses(model, to_device(batch['frame'], dev),
                              to_device(batch['bbox'], dev), points_3d,
                              generator, crop_size=crop_size,
                              conf_threshold=0.6, min_keypoints=0,
                              norm_mean=norm_mean, norm_std=norm_std)
        scores = speed_score_from_matrices(
            out.R, out.trans, to_device(batch['quat'], dev),
            to_device(batch['trans'], dev))
        st = scores.score_t.cpu().numpy()
        sr = scores.score_r.cpu().numpy()
        # a degenerate keypoint set can send the solve non-finite: count
        # those frames instead of letting one NaN swallow the mean
        finite = np.isfinite(st) & np.isfinite(sr)
        n_bad += int((~finite).sum())
        if finite.any():
            score_t.update(float(st[finite].mean()), n=int(finite.sum()))
            score_r.update(float(sr[finite].mean()), n=int(finite.sum()))
        if 'keypoints_2d' in batch:
            err = np.linalg.norm(out.keypoints_2d.cpu().numpy()
                                 - batch['keypoints_2d'], axis=-1)
            sel = out.selected.cpu().numpy()
            if sel.any():
                pix_err.update(float(err[sel].mean()), n=int(sel.sum()))
        if i == 0 and panel_dir:
            _save_panels(panel_dir, batch, out, st + sr)
    if score_t.count == 0:
        # every frame went non-finite: inf, not the meters' initial 0.0,
        # which would read as a perfect score
        score_t.avg = score_r.avg = float('inf')
        if pix_err.count == 0:
            pix_err.avg = float('inf')
    result = {'score_t': score_t.avg, 'score_r': score_r.avg,
              'speed': score_t.avg + score_r.avg, 'pix_err': pix_err.avg,
              'nonfinite': n_bad}
    if panel_dir:
        result['panel_dir'] = panel_dir
    return result


def _save_panels(panel_dir: str, batch: dict, out,
                 speed: np.ndarray) -> None:
    """``frame{j:02d}.png`` for the first ``N_PANELS`` frames of a batch."""
    from esa_pose_estimation_tpu_torch.obs.visual import save_eval_panel
    os.makedirs(panel_dir, exist_ok=True)
    frames = np.asarray(batch['frame'])
    boxes = np.asarray(batch['bbox'])
    kp_pred = out.keypoints_2d.cpu().numpy()
    hms = out.heatmaps.float().cpu().numpy()
    kp_gt = batch.get('keypoints_2d')
    for j in range(min(N_PANELS, frames.shape[0])):
        save_eval_panel(os.path.join(panel_dir, f'frame{j:02d}.png'),
                        frames[j], kp_pred=kp_pred[j],
                        kp_gt=None if kp_gt is None else kp_gt[j],
                        heatmaps=hms[j], bbox=boxes[j],
                        title=f'speed={speed[j]:.4f}')


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--artifact', default=None,
                    help='inference artifact (.npz) to evaluate in place of '
                         'the checkpoint, e.g. artifacts/esa_syn_r5.npz')
    ap.add_argument('--workdir', default='runs/esa',
                    help='the training run: its net_esa/ checkpoints are '
                         'read and load/load_esa.txt is appended')
    ap.add_argument('--checkpoint', default='best_rotate',
                    help='checkpoint name under <workdir>/net_esa')
    ap.add_argument('--test-pkl', required=True)
    ap.add_argument('--image-root', default='')
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--tiny', action='store_true',
                    help='tiny model topology (must match the weights)')
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    model, name = load_weights(args, dev)
    records = speed_data.records_from_pickle(args.test_pkl, args.image_root)
    points_3d = torch.as_tensor(records[0].keypoints_3d, device=dev)
    loader = speed_data.BatchLoader(records,
                                    min(args.batch_size, len(records)),
                                    shuffle=False, drop_last=False)
    cache = EvalCache(model, loader, points_3d, args.crop_size)
    result = evaluate(model, cache, points_3d,
                      torch.Generator(device=dev).manual_seed(0),
                      args.crop_size)

    os.makedirs(os.path.join(args.workdir, 'load'), exist_ok=True)
    with open(os.path.join(args.workdir, 'load', 'load_esa.txt'), 'a') as f:
        f.write('\t'.join(str(v) for v in
                          ['esa', name,
                           round(result['score_t'], 5),
                           round(result['score_r'], 5),
                           round(result['pix_err'], 5)]) + '\n')
    print(f"score_t={result['score_t']:.5f} score_r={result['score_r']:.5f} "
          f"speed={result['speed']:.5f} pix_err={result['pix_err']:.4f} "
          f"nonfinite={result['nonfinite']}")
    return result


if __name__ == '__main__':
    main()
