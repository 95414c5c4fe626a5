"""The reference tools of the port against the JAX package's: VGG
(``models/vgg.py``), pose NMS (``ops/pose_nms.py``), the test-time
transforms (``ops/transforms.py``) and the instance augmentations of
``data/augment.py``, on the same numpy inputs and, where a function is
random, on the same draws.

Tolerances:
- VGG stages (f32, the JAX weights through ``from_jax_variables``), with
  and without BatchNorm: atol 1e-4 rtol 1e-4 (13 layers of f32 convs
  summed in other orders);
- pose NMS: slots, validity and picks equal; merged poses atol 1e-4 px,
  scores atol 1e-6;
- transforms: affine matrices atol 1e-4, points atol 1e-3 px, flips
  exact; warped images atol 1e-2 grey levels (the two f32 solves of the
  affine differ by about 1e-5 px in where a pixel samples, times image
  gradients of up to 255 levels per pixel);
- augmentations: window offsets, masks and integer windows exact; images
  atol 1e-4; keypoints atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.data import augment as jaug
from esa_pose_estimation_tpu.models import vgg as jvgg
from esa_pose_estimation_tpu.ops import pose_nms as jnms
from esa_pose_estimation_tpu.ops import transforms as jtf
from esa_pose_estimation_tpu_torch.data import augment as taug
from esa_pose_estimation_tpu_torch.models import vgg as tvgg
from esa_pose_estimation_tpu_torch.ops import pose_nms as tnms
from esa_pose_estimation_tpu_torch.ops import transforms as ttf
from esa_pose_estimation_tpu_torch.utils.artifact import (
    from_jax_variables,
    to_jax_variables,
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


def _seeded_tree(model):
    """The Flax variables of a seeded port model (``to_jax_variables``;
    the JAX ``apply`` below fails on a path or shape that is not its
    own), with the conv biases made non-zero."""
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('bias'):
                p.uniform_(-0.1, 0.1, generator=torch.Generator()
                           .manual_seed(len(name)))
    return to_jax_variables(model)


@pytest.mark.parametrize('cfg,bn', [('vgg11', True), ('vgg16', False)])
def test_vgg_features_match_jax(cfg, bn):
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = jvgg.VGGFeatures(cfg, batch_norm=bn)
    tm = tvgg.VGGFeatures(cfg, batch_norm=bn)
    variables = _seeded_tree(tm)
    if bn:
        rng = np.random.default_rng(1)
        variables['batch_stats'] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            variables['batch_stats'])
    want = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm.eval()(T(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), N(w),
                                   atol=1e-4, rtol=1e-4)


def test_vgg16_convs_two_scales():
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jm = jvgg.VGG16Convs()
    tm = tvgg.VGG16Convs()
    variables = _seeded_tree(tm)
    want = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm(T(x.transpose(0, 3, 1, 2)))
    assert got[0].shape == (1, 512, 8, 8) and got[1].shape == (1, 512, 4, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), N(w),
                                   atol=1e-4, rtol=1e-4)


def _nms_inputs(seed):
    """Three clusters of near-duplicate poses and some loners."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(50, 400, (3, 1, 17, 2))
    poses = (centers + rng.normal(0, 1.5, (3, 5, 17, 2))).reshape(15, 17, 2)
    poses = np.concatenate([poses, rng.uniform(0, 500, (5, 17, 2))])
    scores = rng.uniform(0.05, 1.0, (20, 17))
    boxes = np.concatenate([poses.min(1), poses.max(1)], -1)
    return (poses.astype(np.float32), scores.astype(np.float32),
            boxes.astype(np.float32))


@pytest.mark.parametrize('seed', [0, 1])
def test_pose_nms_matches_jax(seed, tmp_path):
    poses, scores, boxes = _nms_inputs(seed)
    jref = jnms.ref_dists_from_bboxes(jnp.asarray(boxes))
    tref = tnms.ref_dists_from_bboxes(T(boxes))
    np.testing.assert_allclose(tref.numpy(), N(jref), rtol=1e-6)
    want = jnms.pose_nms(jnp.asarray(poses), jnp.asarray(scores), jref)
    got = tnms.pose_nms(T(poses), T(scores), tref)
    np.testing.assert_array_equal(got.valid.numpy(), N(want.valid))
    assert 3 <= int(got.valid.sum()) < 20
    np.testing.assert_allclose(got.poses.numpy(), N(want.poses), atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), N(want.scores),
                               atol=1e-6)
    np.testing.assert_allclose(got.proposal_score.numpy(),
                               N(want.proposal_score), atol=1e-5)
    results = [{'imgname': 'dir/img_0007.jpg', 'result': [
        {'keypoints': got.poses[i], 'kp_score': got.scores[i],
         'proposal_score': got.proposal_score[i]}
        for i in np.nonzero(got.valid.numpy())[0]]}]
    path = tnms.write_json(results, str(tmp_path / 't'), for_eval=True)
    jpath = jnms.write_json([{'imgname': 'dir/img_0007.jpg', 'result': [
        {'keypoints': N(want.poses[i]), 'kp_score': N(want.scores[i]),
         'proposal_score': float(want.proposal_score[i])}
        for i in np.nonzero(N(want.valid))[0]]}], str(tmp_path / 'j'),
        for_eval=True)
    import json
    tj, jj = json.load(open(path)), json.load(open(jpath))
    assert [r['image_id'] for r in tj] == [r['image_id'] for r in jj] == \
        [7] * len(jj)
    np.testing.assert_allclose([r['keypoints'] for r in tj],
                               [r['keypoints'] for r in jj], atol=1e-4)


def test_flips_match_jax():
    rng = np.random.default_rng(4)
    hm = rng.normal(size=(2, 6, 8, 10)).astype(np.float32)
    pairs = [(0, 1), (3, 5)]
    for mp in ((), pairs):
        np.testing.assert_array_equal(ttf.flip_back(T(hm), mp).numpy(),
                                      N(jtf.flip_back(jnp.asarray(hm), mp)))
    joints = rng.uniform(0, 40, (2, 6, 2)).astype(np.float32)
    vis = (rng.uniform(size=(2, 6, 1)) > 0.3).astype(np.float32)
    for mp in ((), pairs):
        got = ttf.fliplr_joints(T(joints), T(vis), 40, mp)
        want = jtf.fliplr_joints(jnp.asarray(joints), jnp.asarray(vis), 40,
                                 mp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), N(w))


@pytest.mark.parametrize('rot,inv', [(0.0, False), (0.0, True),
                                     (30.0, False), (-45.0, True)])
def test_affine_transform_matches_jax(rot, inv):
    center, scale, size = [120.0, 90.0], [0.8, 1.1], (64, 48)
    want = N(jtf.get_affine_transform(center, scale, rot, size,
                                      shift=(0.1, -0.05), inv=inv))
    got = ttf.get_affine_transform(center, scale, rot, size,
                                   shift=(0.1, -0.05), inv=inv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # batched centres and scalar scale
    c2 = np.array([[120.0, 90.0], [30.0, 40.0]], np.float32)
    got2 = ttf.get_affine_transform(c2, 0.5, rot, size, inv=inv).numpy()
    for i in range(2):
        np.testing.assert_allclose(got2[i], N(jtf.get_affine_transform(
            c2[i], 0.5, rot, size, inv=inv)), atol=1e-4)
    pts = np.random.default_rng(5).uniform(0, 60, (7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.affine_transform(T(pts), T(want)).numpy(),
        N(jtf.affine_transform(jnp.asarray(pts), jnp.asarray(want))),
        atol=1e-3)
    np.testing.assert_allclose(
        ttf.transform_preds(T(pts), center, scale, size).numpy(),
        N(jtf.transform_preds(jnp.asarray(pts), center, scale, size)),
        atol=1e-3)


@pytest.mark.parametrize('scale', [0.3, [0.3, 0.25], 'per-batch'])
def test_crop_matches_jax(scale):
    rng = np.random.default_rng(6)
    imgs = rng.uniform(0, 255, (2, 60, 80)).astype(np.float32)
    centers = np.array([[40.0, 30.0], [35.0, 28.0]], np.float32)
    if scale == 'per-batch':
        scale = np.array([0.3, 0.2], np.float32)
    for rot in (0.0, 20.0):
        want = N(jtf.crop(jnp.asarray(imgs), centers, scale, (48, 40), rot))
        got = ttf.crop(T(imgs), centers, scale, (48, 40), rot).numpy()
        assert got.shape == (2, 40, 48)
        np.testing.assert_allclose(got, want, atol=1e-2)


def _instance_batch(seed, b=3, h=40, w=48):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    masks = np.zeros((b, h, w), np.float32)
    for i in range(b - 1):               # the last mask stays empty
        y0, x0 = rng.integers(2, h // 2), rng.integers(2, w // 2)
        masks[i, y0:y0 + rng.integers(5, h // 2),
              x0:x0 + rng.integers(5, w // 2)] = 1.0
    kp = rng.uniform(0, min(h, w), (b, 5, 2)).astype(np.float32)
    return imgs, masks, kp


def _close(got, want, atol=1e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), N(w), atol=atol)


def test_random_blur_on_jax_draws():
    imgs = np.random.default_rng(7).uniform(0, 255, (4, 20, 24)).astype(
        np.float32)
    key = jax.random.PRNGKey(8)
    want = N(jaug.random_blur(key, jnp.asarray(imgs)))
    coin = N(jax.random.bernoulli(key, 0.5, (4, 1, 1)))[:, 0, 0]
    assert 0 < coin.sum() < 4
    got = taug.random_blur(T(imgs), {'blur': T(coin)}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    d = taug.draw_blur(torch.Generator().manual_seed(0), 64)
    assert d['blur'].dtype == torch.bool and 10 < int(d['blur'].sum()) < 54


@pytest.mark.parametrize('out', [(24, 30), (50, 60), (24, 60)])
def test_fixed_size_window_family_matches_jax(out):
    imgs, masks, kp = _instance_batch(9)
    oh, ow = out
    ranges = taug.instance_window_range(T(masks), oh, ow)
    jranges = jaug.instance_window_range(jnp.asarray(masks), oh, ow)
    for g, w in zip(ranges, jranges):
        np.testing.assert_array_equal(g.numpy(), N(w))
    d = taug.draw_window_begins(torch.Generator().manual_seed(1), ranges)
    assert ((d['hbeg'] >= ranges[0]) & (d['hbeg'] < ranges[1])).all()
    hb, wb = d['hbeg'].numpy(), d['wbeg'].numpy()
    np.testing.assert_array_equal(
        taug.fixed_size_offsets(40, 48, oh, ow, d['hbeg'],
                                d['wbeg']).numpy(),
        N(jaug.fixed_size_offsets(40, 48, oh, ow, jnp.asarray(hb),
                                  jnp.asarray(wb))))
    _close(taug.crop_or_padding_to_fixed_size(
        T(imgs), T(masks), d['hbeg'], d['wbeg'], oh, ow),
        jaug.crop_or_padding_to_fixed_size(
            jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(hb),
            jnp.asarray(wb), oh, ow))
    _close(taug.crop_or_padding_to_fixed_size_instance(
        T(imgs), T(masks), T(kp), d['hbeg'], d['wbeg'], oh, ow),
        jaug.crop_or_padding_to_fixed_size_instance(
            jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(kp),
            jnp.asarray(hb), jnp.asarray(wb), oh, ow))


@pytest.mark.parametrize('ratios', [(0.75, 0.8), (1.3, 1.25), (1.0, 0.5)])
def test_crop_or_padding_matches_jax(ratios):
    imgs, masks, kp = _instance_batch(10)
    _close(taug.crop_or_padding(T(imgs), T(masks), T(kp), *ratios),
           jaug.crop_or_padding(jnp.asarray(imgs), jnp.asarray(masks),
                                jnp.asarray(kp), *ratios))


def test_crop_resize_instance_v1_on_draws_matches_jax():
    imgs, masks, kp = _instance_batch(11)
    for seed in range(3):
        d = taug.draw_crop_resize_v1(torch.Generator().manual_seed(seed),
                                     T(masks), 32, 36)
        assert ((d['ratio'] >= 0.8) & (d['ratio'] < 1.2)).all()
        got = taug.crop_resize_instance_v1(T(imgs), T(masks), T(kp), d, 32,
                                           36)
        want = jaug.crop_resize_instance_v1(
            jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(kp),
            jnp.asarray(d['ratio'].numpy()), jnp.asarray(d['hbeg'].numpy()),
            jnp.asarray(d['wbeg'].numpy()), 32, 36)
        assert got[0].shape == (3, 32, 36, 3)
        np.testing.assert_allclose(got[0].numpy(), N(want[0]), atol=1e-3)
        np.testing.assert_array_equal(got[1].numpy(), N(want[1]))
        np.testing.assert_allclose(got[2].numpy(), N(want[2]), atol=1e-4)
    # a ratio above the frame's size: the window pads
    big = {'ratio': torch.tensor([1.6, 1.0, 1.3]),
           'hbeg': torch.tensor([0, 3, 1], dtype=torch.int32),
           'wbeg': torch.tensor([2, 0, 0], dtype=torch.int32)}
    got = taug.crop_resize_instance_v1(T(imgs), T(masks), T(kp), big, 32, 36)
    want = jaug.crop_resize_instance_v1(
        jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(kp),
        jnp.asarray(big['ratio'].numpy()), jnp.asarray(big['hbeg'].numpy()),
        jnp.asarray(big['wbeg'].numpy()), 32, 36)
    np.testing.assert_allclose(got[0].numpy(), N(want[0]), atol=1e-3)
    np.testing.assert_array_equal(got[1].numpy(), N(want[1]))
