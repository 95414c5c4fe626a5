"""The LINEMOD data and geometry modules of the port against the JAX
package on the same numpy inputs: ``core/camera`` (LINEMOD_K,
``pose_to_matrix``), ``ops/geometry``, ``data/linemod``, the LINEMOD crop
of ``ops/crop``, ``eval/evaluator``, ``eval/projector`` and the instance
augmentations of ``data/augment``.

Tolerances:
- FPS and nearest-neighbour indices, PLY vertices, diameters, the ModelDB
  queries, the pickle records, ``LinemodBatchLoader`` batches and
  ``adjust_bbox_linemod`` (also against the reference's Python-float
  transcription): equal;
- nearest-neighbour distances, ``crop_resize_stretch`` and
  ``normalize_rgb``: atol 1e-4 on the [0, 255] scale or in normalized
  units (f32 products summed in another order);
- ADD, ADD-S, 2D projection and cm/degree errors: rtol 1e-5 (atol 1e-6 m,
  1e-4 px, 1e-3 degrees near 0, where arccos is steep); the accuracy
  triple: the same counts of passing poses (means within 1e-6); AP:
  equal;
- the augmentations on JAX's injected draws: masks equal, images atol
  1e-3 on [0, 255], keypoints atol 1e-4 px; the crop_resize_v2 window
  (r, begins) is asserted first: r within 1e-6 and the begins equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.core import camera as jcam
from esa_pose_estimation_tpu.data import augment as jaug
from esa_pose_estimation_tpu.data import linemod as jlm
from esa_pose_estimation_tpu.eval import evaluator as jev
from esa_pose_estimation_tpu.eval import projector as jproj
from esa_pose_estimation_tpu.ops import crop as jcrop
from esa_pose_estimation_tpu.ops import geometry as jgeo
from esa_pose_estimation_tpu_torch.core import camera as tcam
from esa_pose_estimation_tpu_torch.data import augment as taug
from esa_pose_estimation_tpu_torch.data import linemod as tlm
from esa_pose_estimation_tpu_torch.eval import evaluator as tev
from esa_pose_estimation_tpu_torch.eval import projector as tproj
from esa_pose_estimation_tpu_torch.ops import crop as tcrop
from esa_pose_estimation_tpu_torch.ops import geometry as tgeo
from tests.test_linemod import write_ply_ascii, write_ply_binary
from tests.test_linemod_real import (  # noqa: F401  (data2 is a fixture)
    CLS,
    FRAME_H,
    FRAME_W,
    _reference_linemod_box,
    data2,
)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return np.asarray(a)


def _random_poses(rng, b):
    from scipy.spatial.transform import Rotation
    R = Rotation.random(b, random_state=int(rng.integers(1 << 30))
                        ).as_matrix().astype(np.float32)
    t = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.05, 0.05, b),
                  rng.uniform(0.4, 0.8, b)], -1).astype(np.float32)
    return R, t


def test_linemod_camera_and_pose_matrix():
    np.testing.assert_array_equal(tcam.LINEMOD_K, jcam.LINEMOD_K)
    k = tcam.linemod_k(torch.float32, 'cpu')
    assert k is tcam.linemod_k(torch.float32, 'cpu')      # cached
    np.testing.assert_array_equal(k.numpy(), jcam.LINEMOD_K.astype(
        np.float32))
    R, t = _random_poses(np.random.default_rng(0), 3)
    np.testing.assert_array_equal(tcam.pose_to_matrix(T(R), T(t)).numpy(),
                                  N(jcam.pose_to_matrix(R, t)))


@pytest.mark.parametrize('n,k', [(200, 9), (500, 33), (64, 8)])
def test_farthest_point_sampling_equal(n, k):
    pts = np.random.default_rng(n).normal(scale=0.05, size=(n, 3)).astype(
        np.float32)
    want = N(jgeo.farthest_point_sampling(jnp.asarray(pts), k))
    np.testing.assert_array_equal(
        tgeo.farthest_point_sampling(T(pts), k).numpy(), want)
    # init_center=False (JAX cannot trace it): point 0 first, then the
    # farthest-point rule in float64 numpy
    got = tgeo.farthest_point_sampling(T(pts), k, init_center=False).numpy()
    p64 = pts.astype(np.float64)
    idx = [0]
    dist = np.linalg.norm(p64 - p64[0], axis=-1)
    for _ in range(k - 1):
        idx.append(int(np.argmax(dist)))
        dist = np.minimum(dist, np.linalg.norm(p64 - p64[idx[-1]], axis=-1))
    np.testing.assert_array_equal(got, idx)


def test_nearest_neighbors():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 40, 3)).astype(np.float32)
    r = rng.normal(size=(2, 70, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.nearest_neighbor_index(T(q), T(r)).numpy(),
        N(jgeo.nearest_neighbor_index(q, r)))
    np.testing.assert_allclose(
        tgeo.nearest_neighbor_distance(T(q), T(r)).numpy(),
        N(jgeo.nearest_neighbor_distance(q, r)), atol=1e-4)


def test_ply_diameter_and_model_db(tmp_path):
    rng = np.random.default_rng(4)
    verts = rng.normal(scale=0.05, size=(300, 3)).astype(np.float32)
    write_ply_ascii(tmp_path / 'a.ply', verts)
    write_ply_binary(tmp_path / 'b.ply', verts)
    for name in ('a.ply', 'b.ply'):
        np.testing.assert_array_equal(
            tlm.load_ply_vertices(str(tmp_path / name)),
            jlm.load_ply_vertices(str(tmp_path / name)))
    big = rng.normal(size=(5000, 3))
    assert tlm.model_diameter(big) == jlm.model_diameter(big)
    assert tlm.model_diameter(verts) == jlm.model_diameter(verts)
    tdb, jdb = tlm.LineModModelDB(), jlm.LineModModelDB()
    for db in (tdb, jdb):
        db.register('cat', ply_path=str(tmp_path / 'b.ply'))
        db.register('glue', vertices=verts[:100])
    for cls in ('cat', 'glue'):
        assert tdb.get_diameter(cls) == jdb.get_diameter(cls)
        for fn in ('get_ply_model', 'get_corners_3d', 'get_centers_3d'):
            np.testing.assert_array_equal(getattr(tdb, fn)(cls),
                                          getattr(jdb, fn)(cls))
        for num in (8, 9):
            np.testing.assert_array_equal(tdb.get_farthest_3d(cls, num),
                                          jdb.get_farthest_3d(cls, num))
        assert tdb.is_symmetric(cls) == jdb.is_symmetric(cls)


def test_pickle_plumbing_equal(data2):
    pkl, root, *_ = data2
    for fn, args in ((tlm.load_real_split, ('test',)),
                     (tlm.load_real_split, ('train',)),
                     (tlm.load_occlusion_records, ())):
        got = fn(pkl, CLS, *args)
        want = getattr(jlm, fn.__name__)(pkl, CLS, *args)
        assert [r['rgb_pth'] for r in got] == [r['rgb_pth'] for r in want]
    for kw in ({}, {'use_fuse': False}, {'use_render': False},
               {'render_cap': 1}):
        got = tlm.load_mixed_train_records(pkl, CLS, **kw)
        want = jlm.load_mixed_train_records(pkl, CLS, **kw)
        assert [r['rgb_pth'] for r in got] == [r['rgb_pth'] for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g['bbox'], w['bbox'])
    assert tlm.split_index(('a/b/0017.jpg', 'x')) == 17
    assert tlm.FUSE_CLS_ORDER == jlm.FUSE_CLS_ORDER
    m = np.random.default_rng(5).integers(0, 8, (8, 8, 3)).astype(np.uint8)
    for path, typ in (('fuse/f001.jpg', None), ('real/1.jpg', None),
                      ('fuse/3_rgb.jpg', 'fuse'), ('fuse/3.jpg', 'real')):
        for mm in (m, m[..., 0]):
            np.testing.assert_array_equal(
                tlm.decode_class_mask(mm, path, CLS, rnd_typ=typ),
                jlm.decode_class_mask(mm, path, CLS, rnd_typ=typ))


@pytest.mark.parametrize('shuffle,drop_last', [(True, True), (False, False)])
def test_batch_loader_equal(data2, shuffle, drop_last):
    pkl, root, *_ = data2
    recs = tlm.load_mixed_train_records(pkl, CLS)
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
              frame_hw=(FRAME_H, FRAME_W))
    got = list(tlm.LinemodBatchLoader(recs, root, CLS, 4, **kw))
    want = list(jlm.LinemodBatchLoader(recs, root, CLS, 4, **kw))
    assert len(got) == len(want) == len(tlm.LinemodBatchLoader(
        recs, root, CLS, 4, **kw))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _boxes(rng, n, img_w=640, img_h=480):
    x1 = rng.uniform(-20, img_w - 10, n)
    y1 = rng.uniform(-20, img_h - 10, n)
    return np.stack([x1, y1, x1 + rng.uniform(5, 400, n),
                     y1 + rng.uniform(5, 400, n)], -1).astype(np.float32)


@pytest.mark.parametrize('frame,min_size', [((640, 480), 128),
                                            ((640, 480), 64),
                                            ((128, 96), 32)])
def test_adjust_bbox_linemod_bit_equal(frame, min_size):
    img_w, img_h = frame
    boxes = _boxes(np.random.default_rng(min_size), 300, img_w, img_h)
    got = tcrop.adjust_bbox_linemod(T(boxes), img_w, img_h,
                                    min_size=min_size)
    want = jcrop.adjust_bbox_linemod(jnp.asarray(boxes), img_w, img_h,
                                     min_size=min_size)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), N(w))
    if frame == (640, 480):
        origin, crop_sizes, size = (g.numpy() for g in got)
        for i, b in enumerate(boxes):
            xn, yn, wn, hn, s = _reference_linemod_box(b, min_size, img_w,
                                                       img_h)
            if xn < 0 or yn < 0:     # the JAX package's documented clamp
                continue
            assert (origin[i, 0], origin[i, 1], size[i]) == (xn, yn, s)
            assert tuple(crop_sizes[i]) == (wn - xn, hn - yn)


@pytest.mark.parametrize('k', [1.05, 1.1])
def test_expand_box_int_linemod_margin(k):
    """``_expand_box_int`` at both margins against Python f64, the cases
    of the JAX package's exhaustive check."""
    halves = np.arange(0, 2001, dtype=np.int32)
    for c in (0, 7, 500):
        ca = torch.full((len(halves),), c, dtype=torch.int32)
        sub, _, add, _ = tcrop._expand_box_int(ca, ca, T(halves), k)
        np.testing.assert_array_equal(
            sub.numpy(), [int(c - k * float(h)) for h in halves])
        np.testing.assert_array_equal(
            add.numpy(), [int(c + k * float(h)) for h in halves])


def test_crop_resize_linemod_and_normalize():
    rng = np.random.default_rng(7)
    frames = rng.uniform(0, 255, (3, 96, 128, 3)).astype(np.float32)
    masks = (rng.random((3, 96, 128)) > 0.5).astype(np.float32)
    boxes = _boxes(rng, 3, 128, 96)
    got = tcrop.crop_resize_linemod(T(frames), T(boxes), 32, 128, 96)
    want = jcrop.crop_resize_linemod(jnp.asarray(frames), jnp.asarray(boxes),
                                     32, 128, 96)
    np.testing.assert_allclose(got[0].numpy(), N(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), N(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), N(want[2]))
    o, cs, _ = jcrop.adjust_bbox_linemod(jnp.asarray(boxes), 128, 96,
                                         min_size=32)
    np.testing.assert_allclose(
        tcrop.crop_resize_stretch(T(masks), T(o), T(cs), 32).numpy(),
        N(jcrop.crop_resize_stretch(jnp.asarray(masks), o, cs, 32)),
        atol=1e-5)
    np.testing.assert_allclose(tcrop.normalize_rgb(got[0]).numpy(),
                               N(jcrop.normalize_rgb(want[0])), atol=1e-4)


@pytest.mark.parametrize('symmetric', [False, True])
def test_pose_metrics_equal(symmetric):
    rng = np.random.default_rng(8 + symmetric)
    pts = rng.normal(scale=0.04, size=(300, 3)).astype(np.float32)
    Rg, tg = _random_poses(rng, 6)
    dR, _ = _random_poses(rng, 6)
    # near-truth predictions: half within the 5 px / 5 cm gates
    from scipy.spatial.transform import Rotation
    small = Rotation.from_rotvec(rng.normal(scale=0.03, size=(6, 3))
                                 ).as_matrix().astype(np.float32)
    Rp = np.einsum('bij,bjk->bik', small, Rg).astype(np.float32)
    tp = (tg + rng.normal(scale=0.01, size=tg.shape)).astype(np.float32)
    K = (jcam.LINEMOD_K * 0.2).astype(np.float32)
    K[2, 2] = 1.0
    args_j = [jnp.asarray(a) for a in (Rp, tp, Rg, tg)]
    args_t = [T(a) for a in (Rp, tp, Rg, tg)]
    for fn in ('add_error', 'adds_error'):
        np.testing.assert_allclose(
            getattr(tev, fn)(T(pts), *args_t).numpy(),
            N(getattr(jev, fn)(jnp.asarray(pts), *args_j)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tev.adds_error(T(pts), *args_t, chunk=64).numpy(),
        N(jev.adds_error(jnp.asarray(pts), *args_j, chunk=64)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tev.projection_error_2d(T(pts), T(K), *args_t).numpy(),
        N(jev.projection_error_2d(jnp.asarray(pts), jnp.asarray(K),
                                  *args_j)), rtol=1e-5, atol=1e-4)
    for g, w in zip(tev.cm_degree_error(*args_t),
                    jev.cm_degree_error(*args_j)):
        np.testing.assert_allclose(g.numpy(), N(w), rtol=1e-5, atol=1e-3)
    got = tev.pose_accuracy(T(pts), 0.1, T(K), *args_t, symmetric=symmetric)
    want = jev.pose_accuracy(jnp.asarray(pts), 0.1, jnp.asarray(K), *args_j,
                             symmetric=symmetric)
    # the same counts of passing poses (the f32 means of 6 may round
    # apart by one ulp: JAX multiplies by 1/6)
    assert got.keys() == want.keys()
    for k in got:
        assert round(float(got[k]) * 6) == round(float(want[k]) * 6), k
        assert abs(float(got[k]) - float(want[k])) < 1e-6


def test_average_precision_and_meter():
    rng = np.random.default_rng(9)
    scores = rng.integers(0, 5, 40).astype(np.float32)    # ties
    correct = rng.random(40) > 0.4
    assert float(tev.average_precision(T(scores), T(correct))) == \
        float(jev.average_precision(jnp.asarray(scores),
                                    jnp.asarray(correct)))
    m, mj = tev.AverageMeter(), jev.AverageMeter()
    for v, n in ((0.5, 3), (1.0, 1), (0.0, 4)):
        m.update(v, n)
        mj.update(v, n)
    assert (m.avg, m.sum, m.count) == (mj.avg, mj.sum, mj.count)


def test_projector_equal():
    rng = np.random.default_rng(10)
    pts = rng.normal(scale=0.05, size=(12, 3))
    R, t = _random_poses(rng, 1)
    pose = np.concatenate([R[0], t[0, :, None]], 1)
    assert set(tproj.CAMERAS) == set(jproj.CAMERAS)
    for cam in tproj.CAMERAS:
        np.testing.assert_array_equal(
            tproj.Projector().project(pts, pose, cam),
            jproj.Projector().project(pts, pose, cam))


# --- instance augmentations on JAX's draws ---------------------------------

def _scene(seed=11, b=4, s=48, c=3):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b, s, s, c)).astype(np.float32)
    masks = np.zeros((b, s, s), np.float32)
    for i in range(b):
        y0, x0 = rng.integers(4, s // 2, 2)
        masks[i, y0:y0 + rng.integers(8, s // 2),
              x0:x0 + rng.integers(8, s // 2)] = 1.0
    kps = rng.uniform(8, s - 8, (b, 5, 2)).astype(np.float32)
    return imgs, masks, kps


def test_random_occlusion_on_jax_draws():
    _, masks, _ = _scene()
    b, h, w = masks.shape
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {'cx': T(jax.random.uniform(k1, (b, 1, 1), minval=0.0,
                                        maxval=w - 1.0))[:, 0, 0],
             'cy': T(jax.random.uniform(k2, (b, 1, 1), minval=0.0,
                                        maxval=h - 1.0))[:, 0, 0],
             'half': T(jax.random.uniform(
                 k3, (b, 2), minval=2.0,
                 maxval=jnp.asarray([w, h], jnp.float32) * 0.3 / 2.0))}
    want = N(jaug.random_occlusion(key, jnp.asarray(masks)))
    np.testing.assert_array_equal(taug.random_occlusion(T(masks), draws)
                                  .numpy(), want)
    assert want.sum() < masks.sum()
    d = taug.draw_occlusion(torch.Generator().manual_seed(0), b, h, w)
    assert d['half'].shape == (b, 2) and (d['half'] >= 2.0).all()


def test_random_rotate_and_flip_on_jax_draws():
    imgs, masks, kps = _scene()
    b = imgs.shape[0]
    key = jax.random.PRNGKey(2)
    angle = jax.random.uniform(key, (b,), minval=-30.0, maxval=30.0)
    wi, wm, wk = jaug.random_rotate(key, jnp.asarray(imgs),
                                    jnp.asarray(masks), jnp.asarray(kps),
                                    max_deg=30.0)
    gi, gm, gk = taug.random_rotate(T(imgs), T(masks), T(kps),
                                    {'angle': T(angle)})
    np.testing.assert_array_equal(gm.numpy(), N(wm))
    np.testing.assert_allclose(gi.numpy(), N(wi), atol=1e-3)
    np.testing.assert_allclose(gk.numpy(), N(wk), atol=1e-4)
    flip = jax.random.bernoulli(key, 0.5, (b,))
    assert 0 < int(flip.sum()) < b
    want = jaug.random_flip(key, jnp.asarray(imgs), jnp.asarray(masks),
                            jnp.asarray(kps))
    got = taug.random_flip(T(imgs), T(masks), T(kps), {'flip': T(flip)})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), N(w))


def test_window_shift_and_resize_range():
    imgs, masks, _ = _scene(12)
    off = np.array([[3, -2], [-5, 7], [0, 0], [10, 10]], np.int32)
    np.testing.assert_array_equal(
        taug.window_shift(T(imgs), T(off), 40, 56).numpy(),
        N(jaug.window_shift(jnp.asarray(imgs), jnp.asarray(off), 40, 56)))
    masks[2] = 0.0                                        # empty: [1, 1]
    for g, w in zip(taug.compute_resize_range(T(masks), 30., 135., 30.,
                                              130.),
                    jaug.compute_resize_range(jnp.asarray(masks), 30., 135.,
                                              30., 130.)):
        np.testing.assert_allclose(g.numpy(), N(w), rtol=1e-6)


@pytest.mark.parametrize('seed', [0, 1])
def test_random_crop_resize_v2_on_jax_draws(seed):
    imgs, masks, kps = _scene(13 + seed)
    b, s = masks.shape[:2]
    key = jax.random.PRNGKey(seed)
    kc, kr, kh, kw = jax.random.split(key, 4)
    draws = {'do': T(jax.random.uniform(kc, (b,)) < 0.8),
             'u_r': T(jax.random.uniform(kr, (b,))),
             'u_h': T(jax.random.uniform(kh, (b,))),
             'u_w': T(jax.random.uniform(kw, (b,)))}
    # the JAX window, recomputed from its own draws as its wrapper does
    rlo, rhi = jaug.compute_resize_range(jnp.asarray(masks), 30.0, 135.0,
                                         30.0, 130.0)
    r_j = N(jnp.where(draws['do'].numpy(), draws['u_r'].numpy()
                      * (rhi - rlo) + rlo, 1.0))
    r, hbeg, wbeg = taug.crop_resize_v2_window(T(masks), draws, s, s)
    np.testing.assert_allclose(r.numpy(), r_j, rtol=1e-6)
    wi, wm, wk = jaug.random_crop_resize_v2(key, jnp.asarray(imgs),
                                            jnp.asarray(masks),
                                            jnp.asarray(kps), s, s)
    # the port's begins give JAX's own crop and keypoints (a begin one
    # pixel off would move every keypoint by a pixel); then the port's
    # resample on JAX's r and those begins against JAX's
    gi, gm, gk = taug.crop_resize_instance_v2(
        T(imgs), T(masks), T(kps), T(r_j), torch.ones(b, dtype=torch.bool),
        hbeg, wbeg, s, s)
    ji, jm, jk = jaug.crop_resize_instance_v2(
        jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(kps),
        jnp.asarray(r_j), jnp.ones((b,), bool), jnp.asarray(hbeg.numpy()),
        jnp.asarray(wbeg.numpy()), s, s)
    np.testing.assert_array_equal(N(jm), N(wm))        # same begins as JAX
    np.testing.assert_array_equal(gm.numpy(), N(jm))
    np.testing.assert_allclose(gi.numpy(), N(ji), atol=1e-3)
    np.testing.assert_allclose(gk.numpy(), N(jk), atol=1e-4)
    np.testing.assert_allclose(N(ji), N(wi), atol=1e-3)
    np.testing.assert_allclose(N(jk), N(wk), atol=1e-4)
    # the wrapper composes the two
    for g, w in zip(taug.random_crop_resize_v2(T(imgs), T(masks), T(kps),
                                               draws, s, s),
                    taug.crop_resize_instance_v2(
                        T(imgs), T(masks), T(kps), r,
                        torch.ones(b, dtype=torch.bool), hbeg, wbeg, s, s)):
        assert torch.equal(g, w)
