"""``data/speed_gen.py`` of the port against the JAX package's
exporter (the reference's on-disk SPEED layout), mirroring
tests/test_dress_rehearsal.py's layout checks.

Tolerances: on JAX's poses (``speed_gen._render_split``) the port's
frames are within 1 grey level of JAX's (uint8 truncation of f32 blobs
summed in another order), boxes and keypoints within 1e-3 px, ``RT``
within 1e-6.  The layout, json and ``des`` schema, the 13-character rule
and the unlabelled ``real_test`` are checked on the port's export.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from esa_pose_estimation_tpu.data import speed_gen as jsg
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu_torch.data import speed as tspeed
from esa_pose_estimation_tpu_torch.data import speed_gen as tsg
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn

N_TRAIN, N_TEST, N_REAL = 12, 4, 3
H, W, N_KP = 240, 384, 6


def test_render_split_on_jax_poses():
    frames = list(jsg._render_split(jax.random.PRNGKey(3),
                                    jsyn.spacecraft_points(N_KP), 5, H, W,
                                    batch=4))
    q = np.stack([f[3] for f in frames])
    t = np.stack([f[4] for f in frames])
    got = list(tsg.render_split(None, tsyn.spacecraft_points(n=N_KP), 5, H,
                                W, batch=2, poses=(q, t)))
    assert len(got) == 5
    for (img, bbox, kp, quat, trans), want in zip(got, frames):
        assert img.dtype == np.uint8 and img.shape == (H, W)
        diff = np.abs(img.astype(int) - np.asarray(want[0]).astype(int))
        assert diff.max() <= 1
        np.testing.assert_allclose(bbox, want[1], atol=1e-3)
        np.testing.assert_allclose(kp, want[2], atol=1e-3)
        np.testing.assert_array_equal(quat, want[3])
        np.testing.assert_allclose(tsg.rt_from(quat, trans),
                                   jsg._rt_from(want[3], want[4]),
                                   atol=1e-6)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('speed_layout'))
    return tsg.export_reference_layout(
        root, n_train=N_TRAIN, n_test=N_TEST, n_real_test=N_REAL, height=H,
        width=W, n_kp=N_KP, seed=0, batch=5, device='cpu')


def test_directory_structure(dataset):
    root = dataset['root']
    for split, n in (('train', N_TRAIN), ('test', N_TEST),
                     ('real_test', N_REAL)):
        assert len(os.listdir(os.path.join(root, 'images', split))) == n
        assert os.path.exists(os.path.join(root, f'{split}.json'))
        assert os.path.exists(os.path.join(root, f'{split}.pkl'))


def test_json_schema(dataset):
    with open(dataset['train_json']) as f:
        meta = json.load(f)
    assert len(meta) == N_TRAIN
    assert set(meta[0]) == {'filename', 'q_vbs2tango', 'r_Vo2To_vbs_true'}
    assert len(meta[0]['q_vbs2tango']) == 4
    assert len(meta[0]['r_Vo2To_vbs_true']) == 3
    with open(dataset['real_test_json']) as f:
        real = json.load(f)
    assert len(real) == N_REAL and set(real[0]) == {'filename'}


def test_pickle_des_schema(dataset):
    with open(dataset['train_pkl'], 'rb') as f:
        des = pickle.load(f)
    d = des[0]
    assert set(d) == {'rgb_pth', 'bbox', 'sift', 'sift3d', 'K', 'qua', 'RT'}
    assert d['sift'].shape == (N_KP, 2) and d['sift3d'].shape == (N_KP, 3)
    assert d['RT'].shape == (3, 4) and d['K'].shape == (3, 3)
    np.testing.assert_array_equal(d['sift3d'],
                                  np.asarray(jsyn.spacecraft_points(N_KP)))
    np.testing.assert_allclose(d['K'], np.asarray(
        jsyn.scaled_intrinsics(H, W)), rtol=1e-6)
    # the json poses are the pickle's
    with open(dataset['train_json']) as f:
        meta = json.load(f)
    for m, r in zip(meta, des):
        assert m['filename'] == r['rgb_pth']
        np.testing.assert_allclose(m['q_vbs2tango'], r['qua'], rtol=1e-6)
        np.testing.assert_allclose(m['r_Vo2To_vbs_true'], r['RT'][:, 3],
                                   rtol=1e-6)
    with open(dataset['real_test_pkl'], 'rb') as f:
        rdes = pickle.load(f)[0]
    assert 'qua' not in rdes and 'RT' not in rdes and 'sift' not in rdes


def test_filename_length_routing(dataset):
    with open(dataset['train_pkl'], 'rb') as f:
        names = [d['rgb_pth'] for d in pickle.load(f)]
    assert names[0] == 'img000001.jpg'
    assert all(len(n) == tspeed.SYNTHETIC_NAME_LEN for n in names)
    with open(dataset['real_test_pkl'], 'rb') as f:
        real = [d['rgb_pth'] for d in pickle.load(f)]
    assert all(len(n) != tspeed.SYNTHETIC_NAME_LEN for n in real)


def test_images_decode_and_match_bbox(dataset):
    records = tspeed.records_from_pickle(dataset['train_pkl'],
                                         dataset['train_images'])
    frame = tspeed.read_gray_image(records[0].image_path)
    assert frame.shape == (H, W) and frame.dtype == np.uint8
    x1, y1, x2, y2 = records[0].bbox
    assert 0 <= x1 < x2 <= W and 0 <= y1 < y2 <= H
    inner = frame[int(y1):int(y2), int(x1):int(x2)]
    assert inner.max() > 2 * max(1, int(np.median(frame)))


def test_export_asks_for_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda requested'):
        tsg.main(['--root', str(tmp_path), '--n-train', '1'])
    assert not (tmp_path / 'images').exists()
