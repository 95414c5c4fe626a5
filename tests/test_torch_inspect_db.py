"""``cli/inspect_db.py`` of the port against the JAX package's: the same
printed summary and the same returned statistics, exactly, on the same
pickles (a SPEED split with images, one with a missing image, a
dict-of-lists payload, a single record and an empty list)."""

import os
import pickle

import numpy as np
import pytest

from esa_pose_estimation_tpu.cli import inspect_db as jinspect
from esa_pose_estimation_tpu_torch.cli import inspect_db as tinspect
from esa_pose_estimation_tpu_torch.data import speed_gen


def _pickles(tmp_path):
    out = speed_gen.export_reference_layout(
        str(tmp_path / 'ds'), n_train=5, n_test=3, n_real_test=2,
        height=96, width=160, n_kp=6, batch=4, device='cpu')
    os.remove(os.path.join(out['test_images'], 'img000002.jpg'))
    rng = np.random.default_rng(0)
    recs = [{'rgb_pth': f'{k}.jpg', 'bbox': rng.uniform(0, 50, 4),
             'RT': np.hstack([np.eye(3), rng.uniform(0, 1, (3, 1))]),
             b'cls_typ': b'cat'} for k in range(3)]
    paths = {'dict': str(tmp_path / 'dict.pkl'),
             'one': str(tmp_path / 'one.pkl'),
             'empty': str(tmp_path / 'empty.pkl')}
    for name, payload in (('dict', {'train': recs[:2], 'test': recs[2:]}),
                          ('one', recs[0]), ('empty', [])):
        with open(paths[name], 'wb') as f:
            pickle.dump(payload, f)
    return out, paths


@pytest.fixture(scope='module')
def pickles(tmp_path_factory):
    return _pickles(tmp_path_factory.mktemp('inspect'))


@pytest.mark.parametrize('case', ['train', 'test', 'other'])
def test_summary_equals_jax(pickles, case, capsys):
    out, paths = pickles
    argv = {
        'train': [out['train_pkl'], '--image-root', out['train_images'],
                  '--check-images', '--sample', '2'],
        'test': [out['test_pkl'], out['real_test_pkl'], '--image-root',
                 out['test_images'], '--check-images'],
        'other': [paths['dict'], paths['one'], paths['empty'], '--sample',
                  '5'],
    }[case]
    got = tinspect.main(argv)
    printed = capsys.readouterr().out
    want = jinspect.main(argv)
    assert printed == capsys.readouterr().out
    assert got == want
    if case == 'test':
        assert got[0]['missing_images'] == 1 and got[0]['records'] == 3
        assert got[0]['keypoints'] == 6
