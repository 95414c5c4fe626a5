"""Dress rehearsal of the production chain from disk (port of the JAX
package's ``scripts/dress_rehearsal.py``).

Runs the route real SPEED data takes, at SPEED scale (1920x1200 frames,
``hrnet_esa``) unless told otherwise, end to end from disk, timing each
stage (reference workflow main.py:237-424 -> demo.py -> val.py:94-336):

  1. ``data/speed_gen.export_reference_layout`` — images/train|test|
     real_test JPEGs and train|test|real_test.{json,pkl} in the
     reference's layout
  2. ``records_from_pickle`` -> ``write_shard_from_records`` — the train
     split packed into one SPD1 shard for the C++ loader
  3. ``cli/train --train-shard`` — the native loader, held-out evals on
     the test split, best gates, checkpoints
  4. ``cli/evaluate`` — labelled SPEED scores from ``best_rotate``
  5. ``cli/submit`` — test + real_test -> the leaderboard CSV

Prints one JSON line: seconds per stage, the scores, the CSV's rows and
whether each row has 8 fields.

    python -m esa_pose_estimation_tpu_torch.cli.dress_rehearsal \\
        --root runs/speed_dress [--n-train 480 --epochs 120]

On the CPU at a small size: ``--device cpu --tiny --height 240 --width
384 --n-kp 6 --crop-size 32``.  Unlike the JAX script, which always trains
with ``--no-panels``, the in-train evals draw their PNG panels unless
``--no-panels`` is given (they need matplotlib).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default='runs/speed_dress')
    ap.add_argument('--workdir', default='runs/speed_dress/run')
    ap.add_argument('--n-train', type=int, default=480)
    ap.add_argument('--n-test', type=int, default=64)
    ap.add_argument('--n-real-test', type=int, default=32)
    ap.add_argument('--epochs', type=int, default=120)
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--log-every', type=int, default=15)
    ap.add_argument('--skip-export', action='store_true',
                    help='reuse an existing --root dataset and shard')
    ap.add_argument('--png-shard', action='store_true',
                    help='pack the shard as PNG streams (the reference '
                         'encoding) in place of raw frames; the raw layout '
                         'is the production ingest format, since a PNG '
                         'decode per frame per epoch starves the card on a '
                         'host with few cores')
    ap.add_argument('--no-host-crop', dest='host_crop', action='store_false',
                    help="crop on the card from shipped frames in place of "
                         "on the loader's threads")
    ap.add_argument('--no-augment-geom', dest='augment_geom',
                    action='store_false',
                    help='train without the crop-space flip and rotation (at '
                         'this scale, a few hundred frames over many '
                         'epochs, the net then memorises)')
    ap.add_argument('--eval-every', type=int, default=5,
                    help='epochs between held-out SPEED evals')
    ap.add_argument('--no-panels', dest='panels', action='store_false',
                    help="skip the in-train evals' PNG panels")
    ap.add_argument('--height', type=int, default=1200)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--n-kp', type=int, default=30)
    ap.add_argument('--tiny', action='store_true',
                    help='the tiny model topology, for smoke tests')
    ap.add_argument('--crop-size', type=int, default=128)
    ap.add_argument('--device', default='cuda',
                    help="where to run: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    from esa_pose_estimation_tpu_torch.cli import evaluate as eval_cli
    from esa_pose_estimation_tpu_torch.cli import submit as submit_cli
    from esa_pose_estimation_tpu_torch.cli import train as train_cli
    from esa_pose_estimation_tpu_torch.data import shards, speed, speed_gen

    timing: dict[str, float] = {}
    shard = os.path.join(args.root, 'train.spd1')
    test_pkl = os.path.join(args.root, 'test.pkl')
    test_images = os.path.join(args.root, 'images', 'test')
    model_args = (['--tiny'] if args.tiny else []) + [
        '--crop-size', str(args.crop_size), '--device', args.device]

    if not args.skip_export:
        t0 = time.time()
        print('exporting the reference-layout dataset ...', flush=True)
        speed_gen.export_reference_layout(
            args.root, n_train=args.n_train, n_test=args.n_test,
            n_real_test=args.n_real_test, height=args.height,
            width=args.width, n_kp=args.n_kp, seed=0, batch=8,
            device=args.device)
        timing['export_s'] = round(time.time() - t0, 1)

    if not os.path.exists(shard):
        t0 = time.time()
        print('packing the SPD1 shard ...', flush=True)
        records = speed.records_from_pickle(
            os.path.join(args.root, 'train.pkl'),
            os.path.join(args.root, 'images', 'train'))
        shards.write_shard_from_records(shard, records, height=args.height,
                                        width=args.width,
                                        compressed=args.png_shard)
        timing['shard_s'] = round(time.time() - t0, 1)

    t0 = time.time()
    # held-out evals and the geometric augmentation are the production
    # regime: evaluated on the train shard, the best gates keep memorised
    # weights (the JAX run 1: train split 0.0029, held-out 0.337)
    train_cli.main([
        '--workdir', args.workdir, '--epochs', str(args.epochs),
        '--batch-size', str(args.batch_size),
        '--train-shard', shard, '--loader-threads', '8',
        '--test-pkl', test_pkl, '--image-root', test_images,
        '--eval-every', str(args.eval_every),
        '--log-every', str(args.log_every)] + model_args
        + ([] if args.panels else ['--no-panels'])
        + (['--host-crop'] if args.host_crop else [])
        + (['--augment-geom'] if args.augment_geom else []))
    timing['train_s'] = round(time.time() - t0, 1)

    t0 = time.time()
    result = eval_cli.main([
        '--workdir', args.workdir, '--test-pkl', test_pkl,
        '--image-root', test_images, '--checkpoint', 'best_rotate',
        '--batch-size', str(args.batch_size)] + model_args)
    timing['evaluate_s'] = round(time.time() - t0, 1)

    t0 = time.time()
    csv_path = submit_cli.main([
        '--workdir', args.workdir, '--test-pkl', test_pkl,
        '--image-root', test_images,
        '--real-test-pkl', os.path.join(args.root, 'real_test.pkl'),
        '--real-image-root', os.path.join(args.root, 'images', 'real_test'),
        '--checkpoint', 'best_rotate', '--batch-size', str(args.batch_size),
        '--suffix', 'rehearsal'] + model_args)
    timing['submit_s'] = round(time.time() - t0, 1)

    with open(csv_path) as f:
        rows = list(csv.reader(f))
    out = {
        'timing': timing,
        'total_s': round(sum(timing.values()), 1),
        'eval_score_t': round(result['score_t'], 5),
        'eval_score_r': round(result['score_r'], 5),
        'eval_speed': round(result['speed'], 5),
        'eval_pix_err': round(result['pix_err'], 3),
        'csv_rows': len(rows),
        'csv_rows_expected': args.n_test + args.n_real_test,
        'csv_schema_ok': all(len(r) == 8 for r in rows),
        'csv_path': csv_path,
    }
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
