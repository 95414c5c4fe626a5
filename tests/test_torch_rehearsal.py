"""``cli/dress_rehearsal.py`` end to end on the CPU, at the size of the
JAX chain test (tests/test_dress_rehearsal.py, which is slow-marked and
runs the JAX chain): 48/8/4 frames of 240x384 with 6 keypoints,
``hrnet_tiny`` at crop 32, 2 epochs at batch 8 with an eval each epoch.
Only the port's chain runs here; its parts are each held against JAX in
their own test files.  Checks: every stage ran, the losses and scores
are finite, ``best_rotate`` exists, each eval wrote 4 panels, and the CSV
has 12 rows of 8 fields, finite, unit quaternions, in the splits'
filename order."""

import csv
import json
import math
import os
import pickle

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_TRAIN, N_TEST, N_REAL = 48, 8, 4


@pytest.fixture(scope='module')
def rehearsal(tmp_path_factory):
    from esa_pose_estimation_tpu_torch.cli import dress_rehearsal
    root = str(tmp_path_factory.mktemp('dress'))
    wd = os.path.join(root, 'run')
    argv = ['--root', root, '--workdir', wd, '--n-train', str(N_TRAIN),
            '--n-test', str(N_TEST), '--n-real-test', str(N_REAL),
            '--height', '240', '--width', '384', '--n-kp', '6', '--tiny',
            '--crop-size', '32', '--epochs', '2', '--batch-size', '8',
            '--eval-every', '1', '--log-every', '3', '--device', 'cpu']
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        argv.append('--no-panels')
    return root, wd, dress_rehearsal.main(argv)


def test_json_line(rehearsal):
    _, _, out = rehearsal
    assert set(out['timing']) == {'export_s', 'shard_s', 'train_s',
                                  'evaluate_s', 'submit_s'}
    for k in ('eval_score_t', 'eval_score_r', 'eval_speed',
              'eval_pix_err'):
        assert math.isfinite(out[k]) and out[k] >= 0, k
    assert out['csv_rows'] == out['csv_rows_expected'] == N_TEST + N_REAL
    assert out['csv_schema_ok']


def test_training_logs_and_checkpoints(rehearsal):
    _, wd, _ = rehearsal
    rows = open(os.path.join(wd, 'log_esa.txt')).read().strip().split('\n')
    losses = [float(r.split('\t')[2]) for r in rows[1:]]
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert os.path.exists(os.path.join(wd, 'net_esa', 'best_rotate'))
    with open(os.path.join(wd, 'events.jsonl')) as f:
        evals = [e for e in map(json.loads, f) if e['event'] == 'eval']
    assert [e['epoch'] for e in evals] == [1, 2]
    assert all(math.isfinite(e['speed']) for e in evals)


def test_panels_per_eval(rehearsal):
    pytest.importorskip('matplotlib')
    _, wd, _ = rehearsal
    for ep in (1, 2):
        pdir = os.path.join(wd, 'panels', f'epoch{ep:03d}')
        assert len(os.listdir(pdir)) == 4


def test_csv_rows_in_filename_order(rehearsal):
    root, _, out = rehearsal
    with open(out['csv_path']) as f:
        rows = list(csv.reader(f))
    names = []
    for split in ('test', 'real_test'):
        with open(os.path.join(root, f'{split}.pkl'), 'rb') as f:
            names += [d['rgb_pth'] for d in pickle.load(f)]
    assert [r[0] for r in rows] == names
    for r in rows:
        vals = np.asarray([float(v) for v in r[1:]])
        assert len(r) == 8 and np.isfinite(vals).all()
        assert abs(np.linalg.norm(vals[:4]) - 1.0) < 1e-3
