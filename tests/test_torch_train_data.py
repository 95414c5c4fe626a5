"""The training input path of the port against the JAX package: the
augmentations, ``data/synthetic.make_batch`` and ``data/pipeline.py``.

torch cannot reproduce JAX's random streams, so every test draws with
``jax.random`` exactly as the JAX function does (the ``_jax_*_draws``
helpers mirror its key splits) and injects those draws into the port's
deterministic half (``draws=``).  Tolerances: imagery atol 1e-4 on the
[0, 255] scale (network inputs are mapped back to it); heatmap and weight
targets atol 1e-6; crop-space keypoints atol 1e-4 px; crop origins,
rates, poses and boxes exactly.  Where a rotation is drawn
(``augment_geom``), cos/sin put keypoints and resampling coordinates an
f32 ulp apart, and imagery and targets get the looser limits stated at
each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.data import augment as jaug
from esa_pose_estimation_tpu.data import pipeline as jpipe
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu_torch.data import augment as taug
from esa_pose_estimation_tpu_torch.data import pipeline as tpipe
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MEAN, STD = 0.449, 0.229


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_jitter_draws(key, b):
    kb, kc, ko = jax.random.split(key, 3)
    return {'brightness': _t(jax.random.uniform(kb, (b,), minval=0.9,
                                                maxval=1.1)),
            'contrast': _t(jax.random.uniform(kc, (b,), minval=0.9,
                                              maxval=1.1)),
            'order': _t(jax.random.bernoulli(ko, 0.5, (b,)))}


def _jax_perturb_draws(key, b, h, w):
    kg, ko, kn = jax.random.split(key, 3)
    kb, kv, kn2, ks, kd = jax.random.split(kn, 5)
    sizes = jnp.asarray([3, 5, 7, 9, 11, 15], jnp.int32)
    return {'gain': _t(jax.random.uniform(kg, (b,), minval=0.6,
                                          maxval=1.4)),
            'offset': _t(jax.random.uniform(ko, (b,), minval=-25.0,
                                            maxval=25.0)),
            'gaussian': _t(jax.random.uniform(kb, (b,)) < 0.9),
            'var': _t(jax.random.uniform(kv, (b,)) * 0.3 * 256.0),
            'normal': _t(jax.random.normal(kn2, (b, h, w))),
            'size': _t(sizes[jax.random.randint(ks, (b,), 0, 6)]),
            'horizontal': _t(jax.random.bernoulli(kd, 0.5, (b,)))}


def _jax_geom_draws(key, b, max_deg=25.0):
    kf, kr = jax.random.split(key)
    return {'flip': _t(jax.random.bernoulli(kf, 0.5, (b,))),
            'angle': _t(jax.random.uniform(kr, (b,), minval=-max_deg,
                                           maxval=max_deg))}


def _jax_build_draws(key, b, s, augment_geom, augment_photo):
    draws = {'jitter': _jax_jitter_draws(key, b)}
    if augment_geom:
        draws['geom'] = _jax_geom_draws(jax.random.fold_in(key, 23), b)
    if augment_photo:
        draws['photo'] = _jax_perturb_draws(jax.random.fold_in(key, 29), b,
                                            s, s)
    return draws


def _crops(seed, b=6, s=32):
    """[0, 255] crops: blobs on a dark ground plus noise, integer-valued
    and not."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:s, :s]
    c = rng.uniform(4, s - 4, size=(b, 1, 1, 2))
    img = 220 * np.exp(-((xx - c[..., 0]) ** 2 + (yy - c[..., 1]) ** 2)
                       / 30.0) + rng.uniform(0, 30, size=(b, s, s))
    return img.astype(np.float32)


def _close(got, want, atol, what=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def test_color_jitter_matches_jax():
    x = _crops(0)
    key = jax.random.PRNGKey(5)
    want = jaug.color_jitter(key, jnp.asarray(x))
    got = taug.color_jitter(_t(x), _jax_jitter_draws(key, x.shape[0]))
    _close(got, want, 1e-4)
    # (B, H, W, C) imagery takes the same per-sample draws
    want4 = jaug.color_jitter(key, jnp.asarray(x[..., None]))
    _close(taug.color_jitter(_t(x[..., None]), _jax_jitter_draws(key, 6)),
           want4, 1e-4)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_perturb_capture_matches_jax(seed):
    """Seeds 0-2 of 6 crops give both branches: gaussian noise (with the
    uint8 truncation) and motion blur of several sizes and directions."""
    x = _crops(10 + seed)
    key = jax.random.PRNGKey(seed)
    draws = _jax_perturb_draws(key, 6, 32, 32)
    want = jaug.perturb_capture(key, jnp.asarray(x))
    got = taug.perturb_capture(_t(x), draws)
    _close(got, want, 1e-4)
    assert draws['gaussian'].any() or seed != 0


def test_motion_blur_and_noise_branches_match_jax():
    x = np.round(_crops(3))
    sizes = np.array([3, 5, 7, 9, 11, 15], np.int32)
    horiz = np.array([True, False, True, False, True, False])
    want = jaug.motion_blur(jnp.asarray(x), jnp.asarray(sizes),
                            jnp.asarray(horiz))
    _close(taug.motion_blur(_t(x), _t(sizes), _t(horiz)), want, 1e-4)
    want4 = jaug.motion_blur(jnp.asarray(x[..., None]), jnp.asarray(sizes),
                             jnp.asarray(horiz))
    _close(taug.motion_blur(_t(x[..., None]), _t(sizes), _t(horiz)), want4,
           1e-4)
    noise = np.random.default_rng(4).normal(scale=9, size=x.shape
                                            ).astype(np.float32)
    _close(taug.add_gaussian_noise(_t(x), _t(noise)),
           jaug.add_gaussian_noise(jnp.asarray(x), jnp.asarray(noise)), 1e-4)


def test_draws_have_the_jax_distributions():
    """The port's own draws: the same supports and rates (10,000 samples)."""
    g = torch.Generator().manual_seed(0)
    d = taug.draw_perturb(g, 10_000, 2, 3)
    assert set(d) == set(_jax_perturb_draws(jax.random.PRNGKey(0), 2, 2, 3))
    assert 0.6 <= float(d['gain'].min()) and float(d['gain'].max()) < 1.4
    assert -25 <= float(d['offset'].min()) and float(d['offset'].max()) < 25
    assert abs(float(d['gaussian'].float().mean()) - 0.9) < 0.02
    assert set(d['size'].tolist()) == {3, 5, 7, 9, 11, 15}
    assert 0 <= float(d['var'].min()) and float(d['var'].max()) < 76.8
    assert d['normal'].shape == (10_000, 2, 3)
    j = taug.draw_color_jitter(g, 10_000)
    assert 0.9 <= float(j['brightness'].min()) < 0.91
    assert 1.09 < float(j['contrast'].max()) < 1.1
    geo = tpipe.draw_crop_geom(g, 10_000)
    assert -25 <= float(geo['angle'].min()) and float(geo['angle'].max()) < 25
    assert abs(float(geo['flip'].float().mean()) - 0.5) < 0.02


def test_augment_crop_geom_matches_jax():
    x = _crops(5)
    kp = np.random.default_rng(6).uniform(2, 30, (6, 5, 2)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    wc, wk = jpipe.augment_crop_geom(key, jnp.asarray(x), jnp.asarray(kp))
    gc, gk = tpipe.augment_crop_geom(_t(x), _t(kp), _jax_geom_draws(key, 6))
    _close(gc, wc, 1e-4)
    _close(gk, wk, 1e-4)


def _jax_batch_draws(key, b, s, augment_geom, augment_photo):
    keys = jax.random.split(key, b)
    q, t = jax.vmap(jsyn.random_pose)(keys)
    draws = {'quat': _t(q), 'trans': _t(t)}
    if augment_geom:
        kf, kr = jax.random.split(jax.random.fold_in(key, 17), 2)
        draws['flip'] = _t(jax.random.bernoulli(kf, 0.5, (b,)))
        draws['theta'] = _t(jax.random.uniform(kr, (b,), minval=-jnp.pi,
                                               maxval=jnp.pi))
    if augment_photo:
        draws['photo'] = _jax_perturb_draws(jax.random.fold_in(key, 29), b,
                                            s, s)
    return draws


def _to_255(image):
    return (np.asarray(image) * STD + MEAN) * 255.0


def _jax_sample(batch, draws):
    """The JAX batch's samples (poses, full-frame keypoints, boxes) as the
    port's ``Sample``."""
    return tsyn.Sample(image=None, bbox=_t(batch['bbox']),
                       keypoints_2d=_t(batch['keypoints_2d']),
                       quat=draws['quat'], trans=draws['trans'])


@pytest.mark.parametrize('geom,photo,frames', [
    (False, False, True), (True, False, True), (False, True, True)])
def test_make_batch_matches_jax(geom, photo, frames):
    """The crop rendering on JAX's samples and draws.  Imagery atol 1e-4,
    but 1e-3 with ``augment_geom``: there cos/sin move the crop-space
    keypoints by an f32 ulp (2.4e-6 px) and the crop-space spots, sigma
    down to 0.56 px, have slopes up to about 450 grey levels per px."""
    b, s = 4, 32
    h, w = 300, 480
    key = jax.random.PRNGKey(21)
    want = jsyn.make_batch(key, b, jsyn.spacecraft_points(6), crop_size=s,
                           with_frames=True, height=h, width=w,
                           augment_geom=geom, augment_photo=photo)
    draws = _jax_batch_draws(key, b, s, geom, photo)
    got = tsyn.batch_from_sample(_jax_sample(want, draws), draws,
                                 crop_size=s, with_frames=frames, height=h,
                                 width=w, augment_geom=geom,
                                 augment_photo=photo)
    assert set(got) == set(want)
    _close(_to_255(got['image']), _to_255(want['image']),
           1e-3 if geom else 1e-4, 'image')
    for k in ('heatmaps', 'weights'):
        _close(got[k], want[k], 1e-6, k)
    _close(got['keypoints_crop'], want['keypoints_crop'], 1e-4)
    np.testing.assert_array_equal(got['origin'].numpy(),
                                  np.asarray(want['origin']))
    for k in ('rate', 'quat', 'trans', 'bbox', 'keypoints_2d'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    _close(got['frame'], want['frame'], 1e-4, 'frame')


def test_make_batch_poses_match_jax():
    """make_batch from JAX's pose draws alone: the port projects the
    keypoints itself, within f32 rounding of full-frame coordinates (2
    ulps at 1920 px), and lands on the same crops."""
    b, s = 6, 32
    key = jax.random.PRNGKey(22)
    want = jsyn.make_batch(key, b, jsyn.spacecraft_points(), crop_size=s,
                           with_frames=False)
    draws = _jax_batch_draws(key, b, s, False, False)
    got = tsyn.make_batch(None, b, tsyn.spacecraft_points(), crop_size=s,
                          draws=draws)
    smp = tsyn.sample_from_pose(draws['quat'], draws['trans'],
                                tsyn.spacecraft_points(), render=False)
    _close(smp.bbox, want['bbox'], 2.5e-4)
    np.testing.assert_array_equal(got['origin'].numpy(),
                                  np.asarray(want['origin']))
    np.testing.assert_array_equal(got['rate'].numpy(),
                                  np.asarray(want['rate']))
    _close(got['keypoints_crop'], want['keypoints_crop'], 1e-4)
    _close(got['heatmaps'], want['heatmaps'], 1e-4)


def _frames_and_labels():
    """Three 1920x1200 frames of JAX samples 10-12 m deep, rendered by the
    port, with their boxes and keypoints."""
    keys = jax.random.split(jax.random.PRNGKey(11), 40)
    _, t = jax.vmap(jsyn.random_pose)(keys)
    pick = [i for i, z in enumerate(np.asarray(t)[:, 2]) if 10 <= z <= 12][:3]
    pts = jsyn.spacecraft_points()
    s = jax.vmap(lambda k: jsyn.make_sample(k, pts, render=False))(
        keys[np.array(pick)])
    kp = np.asarray(s.keypoints_2d)
    frames = tsyn.render_frame(_t(kp)).numpy()
    return frames, np.asarray(s.bbox), kp


@pytest.mark.parametrize('train,geom,photo', [
    (True, False, False), (True, True, False), (True, False, True),
    (True, True, True), (False, False, False)])
def test_build_batch_matches_jax(train, geom, photo):
    """On JAX's draws.  With ``augment_geom`` the rotation's cos/sin put
    the crop-space keypoints and the resampling coordinates an f32 ulp
    apart (7.6e-6 px at 64 px): there heatmaps atol 1e-5 and imagery 1e-3
    (measured 2.3e-6 and 1.0e-3 at the crop's sharp edges)."""
    frames, boxes, kp = _frames_and_labels()
    key = jax.random.PRNGKey(31)
    want = jpipe.build_batch(jnp.asarray(frames), jnp.asarray(boxes),
                             jnp.asarray(kp), key, crop_size=64, train=train,
                             augment_geom=geom, augment_photo=photo)
    draws = (_jax_build_draws(key, 3, 64, geom, photo) if train else {})
    got = tpipe.build_batch(_t(frames), _t(boxes), _t(kp), crop_size=64,
                            train=train, augment_geom=geom,
                            augment_photo=photo, draws=draws)
    assert set(got) == set(want)
    _close(_to_255(got['image']), _to_255(want['image']),
           1e-3 if geom else 1e-4, 'image')
    for k in ('heatmaps', 'weights'):
        _close(got[k], want[k], 1e-5 if geom else 1e-6, k)
    _close(got['keypoints_crop'], want['keypoints_crop'], 1e-4)
    np.testing.assert_array_equal(got['origin'].numpy(),
                                  np.asarray(want['origin']))
    np.testing.assert_array_equal(got['rate'].numpy(),
                                  np.asarray(want['rate']))


@pytest.mark.parametrize('geom,photo', [(False, False), (True, True)])
def test_build_batch_from_crops_matches_jax(geom, photo):
    """Tolerances as for ``build_batch``."""
    x = _crops(7, b=4)
    rates = np.array([0.5, 0.25, 0.4, 1.0], np.float32)
    origins = np.array([[100, 40], [8, 900], [1500, 20], [0, 0]], np.int32)
    kp = (origins[:, None, :] + np.random.default_rng(1).uniform(
        0, 30, (4, 6, 2)) / rates[:, None, None]).astype(np.float32)
    key = jax.random.PRNGKey(41)
    want = jpipe.build_batch_from_crops(
        jnp.asarray(x), jnp.asarray(rates), jnp.asarray(origins),
        jnp.asarray(kp), key, augment_geom=geom, augment_photo=photo)
    got = tpipe.build_batch_from_crops(
        _t(x), _t(rates), _t(origins), _t(kp), augment_geom=geom,
        augment_photo=photo, draws=_jax_build_draws(key, 4, 32, geom, photo))
    _close(_to_255(got['image']), _to_255(want['image']),
           1e-3 if geom else 1e-4, 'image')
    for k in ('heatmaps', 'weights'):
        _close(got[k], want[k], 1e-5 if geom else 1e-6, k)
    _close(got['keypoints_crop'], want['keypoints_crop'], 1e-4)


def test_generator_draws_drive_every_path():
    """Without injected draws each function draws from its generator: the
    same seed gives the same batch, and the batch is well formed."""
    pts = tsyn.spacecraft_points(n=6)
    a, b = (tsyn.make_batch(torch.Generator().manual_seed(3), 2, pts,
                            crop_size=32, augment_geom=True,
                            augment_photo=True) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a['image'].shape == (2, 32, 32, 1)
    assert a['heatmaps'].shape == a['weights'].shape == (2, 32, 32, 6)
    frames, boxes, kp = _frames_and_labels()
    out = tpipe.build_batch(_t(frames), _t(boxes), _t(kp),
                            torch.Generator().manual_seed(0), crop_size=32,
                            augment_geom=True, augment_photo=True)
    assert torch.isfinite(out['image']).all()
    assert out['heatmaps'].shape == (3, 32, 32, 30)


def test_prefetch_to_device_keeps_order_and_passes_names():
    batches = [{'frame': np.full((2, 3), i, np.uint8), 'name': [f'n{i}']}
               for i in range(5)]
    seen = []

    def source():
        for b in batches:
            seen.append(b['name'][0])
            yield b
    out = []
    for b in tpipe.prefetch_to_device(source(), 'cpu', size=2):
        # two batches are staged ahead of the one handed out
        assert len(seen) - len(out) <= 3
        out.append(b)
    assert [b['name'] for b in out] == [b['name'] for b in batches]
    assert all(isinstance(b['frame'], torch.Tensor)
               and int(b['frame'][0, 0]) == i for i, b in enumerate(out))
