"""Submission command: the reference ``val.py`` as a command.

    python -m esa_pose_estimation_tpu_torch.cli.submit --workdir runs/esa \\
        --test-pkl data/test.pkl [--real-test-pkl data/real_test.pkl] \\
        --image-root /data/speed/images/ \\
        [--checkpoint best_rotate | --artifact artifacts/esa_syn_r5.npz] \\
        [--device cpu]

Port of the JAX package's ``cli/submit.py``.  It runs batched inference
over the synthetic ``test`` and the ``real_test`` partitions (no labels)
with the competition's keypoint selection (confidence > 0.8 with a floor of
24 keypoints, val.py:172-175), solves the poses, and writes the
leaderboard CSV with ``eval/submission.SubmissionWriter`` into
``--workdir``.  It serves through ``pipeline.make_jitted_pipeline``: on
the card one CUDA graph per batch shape (a partition's last, smaller
batch takes a second one).  The weights come from the port checkpoint
``<workdir>/net_esa/<--checkpoint>``, or from ``--artifact`` when one is
given (``cli/evaluate.load_weights``).  Reading image files needs Pillow.
"""

from __future__ import annotations

import argparse

import torch

from esa_pose_estimation_tpu_torch.cli.evaluate import load_weights
from esa_pose_estimation_tpu_torch.data import speed as speed_data
from esa_pose_estimation_tpu_torch.data.speed import to_device
from esa_pose_estimation_tpu_torch.eval.submission import SubmissionWriter
from esa_pose_estimation_tpu_torch.pipeline import make_jitted_pipeline


def run_partition(model, records, points_3d, writer: SubmissionWriter,
                  real: bool, generator: torch.Generator | None = None,
                  batch_size: int = 32, crop_size: int = 128,
                  norm_mean: float = 0.485, crop_rule: str = 'val',
                  flip_tta: bool = False) -> None:
    """Poses of one partition's records, batch by batch, into ``writer``
    (one host read-back per batch)."""
    dev = next(model.parameters()).device
    loader = speed_data.BatchLoader(records, min(batch_size, len(records)),
                                    shuffle=False, drop_last=False)
    run = make_jitted_pipeline(model, points_3d, crop_size=crop_size,
                               conf_threshold=0.8, min_keypoints=24,
                               norm_mean=norm_mean, crop_rule=crop_rule,
                               flip_tta=flip_tta)
    for batch in loader:
        out = run(to_device(batch['frame'], dev),
                  to_device(batch['bbox'], dev), generator)
        writer.append_batch(batch['name'], out.quat.cpu().numpy(),
                            out.trans.cpu().numpy(), real=real)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--artifact', default=None,
                    help='inference artifact (.npz) in place of the '
                         'checkpoint, e.g. artifacts/esa_syn_r5.npz')
    ap.add_argument('--workdir', default='runs/esa',
                    help='the training run: its net_esa/ checkpoints are '
                         'read and the submission CSV is written there')
    ap.add_argument('--checkpoint', default='best_rotate',
                    help='checkpoint name under <workdir>/net_esa')
    ap.add_argument('--test-pkl', required=True)
    ap.add_argument('--real-test-pkl', default=None)
    ap.add_argument('--image-root', default='')
    ap.add_argument('--real-image-root', default=None,
                    help='image directory for the real_test partition '
                         '(defaults to --image-root; the reference keeps '
                         'the partitions under separate images/test and '
                         'images/real_test directories, utils.py:30-38)')
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--norm-mean', type=float, default=0.485,
                    help='crop normalization mean: 0.485 matches the '
                         'reference submission loader (data_load_val.py:'
                         '84-88, the default); pass 0.449 to match the '
                         'training transform instead (data_load4.py:81)')
    ap.add_argument('--crop-rule', choices=('val', 'train'), default='val',
                    help='box rule: "val" = ESAValDataSet submission crop '
                         '(no square-equalization, data_load_val.py:125-157'
                         ', the default); "train" = data_load4 rule')
    ap.add_argument('--flip-tta', action='store_true',
                    help='average heatmaps with a mirrored-input forward '
                         'pass (transforms.py:16-30 flip_back semantics), '
                         'at 2x keypoint-network cost')
    ap.add_argument('--suffix', default=None)
    ap.add_argument('--tiny', action='store_true',
                    help='tiny model topology (must match the weights)')
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> str:
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    model, _ = load_weights(args, dev)
    writer = SubmissionWriter()
    gen = torch.Generator(device=dev).manual_seed(7)
    kw = dict(batch_size=args.batch_size, crop_size=args.crop_size,
              norm_mean=args.norm_mean, crop_rule=args.crop_rule,
              flip_tta=args.flip_tta)

    test_records = speed_data.records_from_pickle(args.test_pkl,
                                                  args.image_root)
    points_3d = torch.as_tensor(test_records[0].keypoints_3d, device=dev)
    run_partition(model, test_records, points_3d, writer, real=False,
                  generator=gen, **kw)
    if args.real_test_pkl:
        real_records = speed_data.records_from_pickle(
            args.real_test_pkl,
            args.image_root if args.real_image_root is None
            else args.real_image_root)
        run_partition(model, real_records, points_3d, writer, real=True,
                      generator=gen, **kw)
    path = writer.export(out_dir=args.workdir, suffix=args.suffix)
    print(f'Submission saved to {path}.')
    return path


if __name__ == '__main__':
    main()
