"""``data/db_builder.py`` of the port against the JAX package's, on one
raw LINEMOD layout (mirrors tests/test_db_builder.py): the built records
equal JAX's field for field (arrays exactly, keypoints from the same FPS
points), the fuse composites equal JAX's pixel for pixel from the same
seed, and the port's data2/ loaders and ``LinemodBatchLoader`` read what
the builders wrote."""

import os
import pickle

import numpy as np
import pytest

from esa_pose_estimation_tpu.data import db_builder as jdbb
from esa_pose_estimation_tpu.data import linemod as jlm
from esa_pose_estimation_tpu_torch.data import db_builder as dbb
from esa_pose_estimation_tpu_torch.data import linemod as lm

CLS = 'cat'
H, W = 480, 640


def _save_img(path, arr):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _cube_vertices(side=0.06):
    s = side / 2
    g = np.array([-s, s])
    return np.array([[x, y, z] for x in g for y in g for z in g])


def _pose(rng):
    a = rng.normal(scale=0.2, size=3)
    th = np.linalg.norm(a) + 1e-9
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
    t = np.array([rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                  rng.uniform(0.5, 0.8)])
    return np.hstack([R, t[:, None]]).astype(np.float32)


def _mask(RT, K):
    pts = dbb.project_K(_cube_vertices(), RT, K)
    m = np.zeros((H, W), np.uint8)
    x1, y1 = np.clip(pts.min(0).astype(int), 0, None)
    x2, y2 = pts.max(0).astype(int)
    m[y1:y2 + 1, x1:x2 + 1] = 255
    return m


def _write_pose(pd, k, RT):
    os.makedirs(pd, exist_ok=True)
    with open(os.path.join(pd, f'rot{k}.rot'), 'w') as f:
        f.write('3 3\n' + '\n'.join(' '.join(f'{v:.7f}' for v in row)
                                    for row in RT[:, :3]))
    with open(os.path.join(pd, f'tra{k}.tra'), 'w') as f:
        f.write('1 3\n' + ' '.join(f'{v:.7f}' for v in RT[:, 3] * 100))


@pytest.fixture
def layout(tmp_path):
    """4 real frames, 3 renders, an occlusion tree of 2 frames (one
    without a pose); the two packages' model DBs on the same cube."""
    rng = np.random.default_rng(7)
    root = str(tmp_path / 'LM')
    K = dbb.LINEMOD_K
    for k in range(4):
        RT = _pose(rng)
        m = _mask(RT, K)
        _save_img(os.path.join(root, CLS, 'JPEGImages', f'{k:06d}.jpg'),
                  np.broadcast_to(m[..., None], (H, W, 3)).copy())
        _save_img(os.path.join(root, CLS, 'mask', f'{k:04d}.png'), m)
        _write_pose(os.path.join(root, CLS, 'data'), k, RT)
    rdir = os.path.join(root, 'renders', CLS)
    for k in range(3):
        RT = _pose(rng)
        m = _mask(RT, K)
        _save_img(os.path.join(rdir, f'{k}.jpg'),
                  np.broadcast_to(m[..., None], (H, W, 3)).copy())
        _save_img(os.path.join(rdir, f'{k}_depth.png'), m)
        with open(os.path.join(rdir, f'{k}_RT.pkl'), 'wb') as f:
            pickle.dump({'RT': RT}, f)
    for k in range(2):
        RT = _pose(rng)
        m = _mask(RT, K)
        _save_img(os.path.join(root, 'RGB-D', 'rgb_noseg',
                               f'color_{k:05d}.png'),
                  np.broadcast_to(m[..., None], (H, W, 3)).copy())
        _save_img(os.path.join(root, 'masks', CLS, f'{k}.png'), m)
        if k == 0:
            _write_pose(os.path.join(root, 'poses', 'Cat'), k, RT)
    db, jdb = lm.LineModModelDB(), jlm.LineModModelDB()
    db.register(CLS, vertices=_cube_vertices())
    jdb.register(CLS, vertices=_cube_vertices())
    return root, db, jdb, str(tmp_path / 'jax_out')


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_constants_and_helpers_equal_jax():
    np.testing.assert_array_equal(dbb.LINEMOD_K, jdbb.LINEMOD_K)
    rng = np.random.default_rng(0)
    RT = _pose(rng)
    pts = rng.normal(size=(10, 3)) * 0.05
    np.testing.assert_array_equal(dbb.project_K(pts, RT, dbb.LINEMOD_K),
                                  jdbb.project_K(pts, RT, jdbb.LINEMOD_K))
    m = _mask(RT, dbb.LINEMOD_K)
    np.testing.assert_array_equal(dbb.mask_to_bbox(m), jdbb.mask_to_bbox(m))
    np.testing.assert_array_equal(dbb.mask_to_bbox(m * 0), np.zeros(4))


@pytest.mark.parametrize('which', ['real', 'render', 'occlusion'])
def test_builders_equal_jax(layout, which):
    root, db, jdb, jout = layout
    fn = {'real': 'build_real_db', 'render': 'build_render_db',
          'occlusion': 'build_occlusion_db'}[which]
    got = getattr(dbb, fn)(root, CLS, db, n_kp=8)
    want = getattr(jdbb, fn)(root, CLS, jdb, n_kp=8, out_dir=jout)
    _assert_records_equal(got, want)
    loaded = (lm.load_occlusion_records(root, CLS) if which == 'occlusion'
              else lm._load_pkl(os.path.join(root, f'{CLS}_{which}.pkl')))
    _assert_records_equal(loaded, want)
    if which == 'occlusion':
        assert len(got) == 1 and got[0]['rgb_pth'].endswith(
            'color_00000.png')


def test_split_and_mixed_consumption(layout):
    root, db, jdb, jout = layout
    real = dbb.build_real_db(root, CLS, db, n_kp=8)
    dbb.build_render_db(root, CLS, db, n_kp=8)
    train, test = dbb.build_split_pkls(real, root, CLS, test_fraction=0.5)
    jtrain, jtest = jdbb.build_split_pkls(real, root, CLS,
                                          test_fraction=0.5, out_dir=jout)
    assert (train, test) == (jtrain, jtest)
    mixed = lm.load_mixed_train_records(root, CLS, use_fuse=False)
    assert [r['rnd_typ'] for r in mixed] == ['real'] * 2 + ['render'] * 3
    assert len(lm.load_real_split(root, CLS, 'test')) == 2


def test_fuse_compose_and_collect_equal_jax(layout):
    from PIL import Image
    root, db, jdb, jout = layout
    renders = {CLS: os.path.join('renders', CLS)}
    assert dbb.compose_fuse_set(root, renders, n_images=3, frame_hw=(H, W),
                                max_shift=6) == 3
    jdbb.compose_fuse_set(root, renders, n_images=3, out_dir='jfuse',
                          frame_hw=(H, W), max_shift=6)
    for k in range(3):
        for name in (f'{k}_rgb.jpg', f'{k}_mask.png'):
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(root, 'fuse', name))),
                np.asarray(Image.open(os.path.join(root, 'jfuse', name))))
    got = dbb.build_fuse_db(root, CLS, db, n_kp=8, min_px=10)
    want = jdbb.build_fuse_db(root, CLS, jdb, n_kp=8, min_px=10,
                              out_dir=jout)
    assert len(got) >= 1
    _assert_records_equal(got, want)
    r = got[0]
    m = np.asarray(Image.open(os.path.join(root, str(r['dpt_pth']))))
    assert lm.decode_class_mask(m, str(r['rgb_pth']), CLS,
                                rnd_typ=r['rnd_typ']).sum() >= 10


def test_batch_loader_reads_built_db(layout):
    root, db, _, _ = layout
    real = dbb.build_real_db(root, CLS, db, n_kp=8)
    dbb.build_split_pkls(real, root, CLS, test_fraction=0.5)
    recs = lm.load_real_split(root, CLS, 'train')
    loader = lm.LinemodBatchLoader(recs, root, CLS, batch_size=2,
                                   shuffle=False, frame_hw=(H, W))
    b = next(iter(loader))
    assert b['frame'].shape == (2, H, W, 3)
    assert b['keypoints_2d'].shape == (2, 8, 2)
    assert b['mask'].sum() > 0
    assert 'R' in b and 't' in b
