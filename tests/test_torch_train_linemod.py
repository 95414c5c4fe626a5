"""The LINEMOD slice of the port as a whole: the well-posed synthetic
harness in both packages on the same batch, and ``cli.train_linemod`` in
both modes from both data sources on the CPU.

The harness (tests/test_train_linemod.py::test_synthetic_harness_well_posed
at crop 64, batch 4, 7 keypoints): JAX's rendered batch is recomputed by
the port from JAX's pose draws; ideal targets then go through heatmaps ->
decode -> RANSAC-EPnP, and through the vertex field -> RANSAC voting ->
the distribution around the winners -> uncertainty PnP, with JAX's Gumbel
draws and RANSAC masks injected.  Tolerances:
- the batch: R, t, K and keypoints rtol 1e-5 (atol 1e-4 px); masks equal
  but for at most 0.5% of the covered pixels (triangle-edge pixels, see
  tests/test_torch_render.py); shaded image atol 1e-5 where both masks
  cover;
- both routes score 1.0 on 2D projection and ADD in both packages, and
  the port's poses are within 0.05 degrees and 1e-4 m of JAX's (the
  voting routes sum votes in another order, tests/test_torch_voting.py).

The commands (crop 64, 5 keypoints, one epoch of two steps at batch 4;
the real layout at crop 32 on tests/test_linemod_real.py's fixture) write
the files the JAX driver writes: ``log_<cls>.txt`` (the same header,
one row per epoch), ``events.jsonl`` with an ``eval`` event per epoch
carrying the LINEMOD triple, ``net_<cls>/last`` and ``best_add``, and
with ``--occ-pkl-dir`` one ``occ_result.txt`` row of the class and three
numbers in [0, 1].
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.cli import train_linemod as jtl
from esa_pose_estimation_tpu.data.linemod import LineModModelDB as JDB
from esa_pose_estimation_tpu.eval import evaluator as jev
from esa_pose_estimation_tpu.ops import heatmap as jhm
from esa_pose_estimation_tpu.ops import peak as jpeak
from esa_pose_estimation_tpu.ops import pnp as jpnp
from esa_pose_estimation_tpu.ops import vertex as jvert
from esa_pose_estimation_tpu.ops import voting as jvot
from esa_pose_estimation_tpu_torch.cli import train_linemod as ttl
from esa_pose_estimation_tpu_torch.data.linemod import LineModModelDB
from esa_pose_estimation_tpu_torch.eval import evaluator as tev
from esa_pose_estimation_tpu_torch.ops import heatmap as thm
from esa_pose_estimation_tpu_torch.ops import peak as tpeak
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp
from esa_pose_estimation_tpu_torch.ops import vertex as tvert
from esa_pose_estimation_tpu_torch.ops import voting as tvot
from tests.test_linemod_real import (  # noqa: F401  (data2 is a fixture)
    CLS,
    FRAME_H,
    FRAME_W,
    data2,
)
from tests.test_torch_voting import _angle_deg, jax_draws


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, B, NK = 64, 4, 7


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return np.asarray(a)


@pytest.fixture(scope='module')
def jax_harness():
    """The JAX harness once, jitted: its batch, the heatmap route's pose
    and the pvnet route's pose, and both routes' accuracy."""
    db = JDB()
    verts, faces = jtl.make_icosphere()
    db.register('cat', vertices=verts)
    kp3d = jnp.asarray(db.get_farthest_3d('cat', NK), jnp.float32)
    pts = jnp.asarray(verts)

    @jax.jit
    def run(key):
        b = jtl.synthetic_linemod_batch(key, B, db, pts, jnp.asarray(faces),
                                        kp3d, S)
        p3 = jnp.broadcast_to(kp3d, (B,) + kp3d.shape)
        hm, _ = jhm.render_targets(b['keypoints_2d'], S, S, 2.0)
        coords, _ = jpeak.decode_heatmaps(hm)
        res = jpnp.ransac_epnp(p3, coords, b['K'], jax.random.PRNGKey(3))
        field = jvert.vertex_field(b['mask'], b['keypoints_2d'])
        vres = jvot.ransac_voting(b['mask'], field, jax.random.PRNGKey(4))
        kp_mean, kp_cov = jvot.estimate_voting_distribution_with_mean(
            b['mask'], field, vres.keypoints, jax.random.PRNGKey(6))
        R2, t2 = jpnp.uncertainty_pnp(p3, kp_mean, kp_cov, b['K'],
                                      jax.random.PRNGKey(5))
        accs = [jev.pose_accuracy(pts, db.get_diameter('cat'), b['K'], R, t,
                                  b['R'], b['t'])
                for R, t in ((res.R, res.t), (R2, t2))]
        return b, (res.R, res.t), (R2, t2), accs

    key = jax.random.PRNGKey(2)
    b, heat, pv, accs = jax.tree_util.tree_map(N, run(key))
    # the pose draws of jtl.synthetic_linemod_batch, from its own keys
    draws = {'quat': [], 'tz': []}
    for k in jax.random.split(key, B):
        kq, kt = jax.random.split(k)
        draws['quat'].append(N(jax.random.normal(kq, (4,))))
        draws['tz'].append(float(jax.random.uniform(kt, (), minval=0.35,
                                                    maxval=0.55)))
    return {'batch': b, 'heatmap': heat, 'pvnet': pv, 'accs': accs,
            'draws': {'quat': T(np.stack(draws['quat'])),
                      'tz': T(np.float32(draws['tz']))},
            'verts': verts, 'faces': faces, 'kp3d': N(kp3d)}


@pytest.fixture(scope='module')
def port_batch(jax_harness):
    db = LineModModelDB()
    db.register('cat', vertices=jax_harness['verts'])
    kp3d = T(db.get_farthest_3d('cat', NK)).to(torch.float32)
    np.testing.assert_array_equal(kp3d.numpy(), jax_harness['kp3d'])
    b = ttl.synthetic_linemod_batch(None, B, T(jax_harness['verts']),
                                    T(jax_harness['faces']), kp3d, S,
                                    draws=jax_harness['draws'])
    return db, kp3d, b


def test_synthetic_batch_matches_jax(jax_harness, port_batch):
    jb = jax_harness['batch']
    _, _, b = port_batch
    for k in ('R', 't', 'K', 'keypoints_2d'):
        np.testing.assert_allclose(b[k].numpy(), jb[k], rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    tm, jm = b['mask'].numpy() > 0, jb['mask'] > 0
    assert (tm != jm).sum() <= 0.005 * (tm | jm).sum()
    both = tm & jm
    np.testing.assert_allclose(b['image'].numpy()[both], jb['image'][both],
                               atol=1e-5)
    imgs = b['image'].numpy()
    assert imgs.max() > 0.5 and not np.allclose(imgs[0], imgs[1])
    assert set(np.unique(b['mask'].numpy())) <= {0.0, 1.0}


def _accuracy(db, b, R, t):
    return {k: float(v) for k, v in tev.pose_accuracy(
        T(db.get_ply_model('cat')).to(torch.float32), db.get_diameter('cat'),
        b['K'], R, t, b['R'], b['t']).items()}


def test_harness_heatmap_route(jax_harness, port_batch):
    db, kp3d, b = port_batch
    p3 = kp3d.expand((B,) + kp3d.shape)
    hm, _ = thm.render_targets(b['keypoints_2d'], S, S, 2.0)
    coords, _ = tpeak.decode_heatmaps_auto_nhwc(hm.permute(0, 2, 3, 1))
    masks = jpnp._sample_masks(jax.random.PRNGKey(3), (B,), NK, 64, 6,
                               jnp.ones((B, NK), bool))
    res = tpnp.ransac_epnp(p3, coords, b['K'], masks=T(masks))
    acc = _accuracy(db, b, res.R, res.t)
    assert acc['projection_2d'] == 1.0 and acc['add'] == 1.0
    ja = jax_harness['accs'][0]
    assert float(ja['projection_2d']) == 1.0 and float(ja['add']) == 1.0
    jR, jt = jax_harness['heatmap']
    assert _angle_deg(res.R.numpy(), jR).max() < 0.05
    np.testing.assert_allclose(res.t.numpy(), jt, atol=1e-4)


def test_harness_pvnet_route(jax_harness, port_batch):
    db, kp3d, b = port_batch
    p3 = kp3d.expand((B,) + kp3d.shape)
    field = tvert.vertex_field(b['mask'], b['keypoints_2d'])
    vres = tvot.ransac_voting(b['mask'], field, draws=jax_draws(
        jax.random.PRNGKey(4), B, S * S, 2048, 128))
    kp_mean, kp_cov = tvot.estimate_voting_distribution_with_mean(
        b['mask'], field, vres.keypoints, draws=jax_draws(
            jax.random.PRNGKey(6), B, S * S, 2048, 1024))
    masks = jpnp._sample_masks(jax.random.PRNGKey(5), (B,), NK, 32, 6,
                               jnp.ones((B, NK), bool))
    R, t = tpnp.uncertainty_pnp(p3, kp_mean, kp_cov, b['K'], masks=T(masks))
    acc = _accuracy(db, b, R, t)
    assert acc['projection_2d'] == 1.0 and acc['add'] == 1.0
    ja = jax_harness['accs'][1]
    assert float(ja['projection_2d']) == 1.0 and float(ja['add']) == 1.0
    jR, jt = jax_harness['pvnet']
    assert _angle_deg(R.numpy(), jR).max() < 0.05
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-4)


def _check_run(wd, epochs, occ=False):
    log = (wd / f'log_{CLS}.txt').read_text().strip().split('\n')
    assert log[0] == 'Epoch\tLR\tTrain Loss'
    assert len(log) == 1 + epochs
    losses = [float(row.split('\t')[2]) for row in log[1:]]
    assert all(math.isfinite(v) for v in losses)
    events = [json.loads(x) for x in (wd / 'events.jsonl').open()]
    evals = [e for e in events if e['event'] == 'eval']
    assert [e['epoch'] for e in evals] == list(range(1, epochs + 1))
    for e in evals:
        assert all(0.0 <= e[k] <= 1.0
                   for k in ('projection_2d', 'add', 'cm_degree_5'))
    assert (wd / f'net_{CLS}' / 'last').is_file()
    assert (wd / f'net_{CLS}' / 'best_add').is_file()
    if occ:
        rows = (wd / 'occ_result.txt').read_text().strip().split('\n')
        assert len(rows) == 1
        f = rows[0].split('\t')
        assert f[0] == CLS and len(f) == 4
        assert all(0.0 <= float(v) <= 1.0 for v in f[1:])
    return losses


@pytest.mark.parametrize('mode', ['heatmap', 'pvnet'])
def test_cli_synthetic(tmp_path, mode):
    wd = tmp_path / mode
    argv = ['--workdir', str(wd), '--mode', mode, '--epochs', '1',
            '--steps-per-epoch', '2', '--batch-size', '4', '--crop-size',
            '64', '--num-keypoints', '5', '--device', 'cpu']
    res = ttl.main(argv)
    assert set(res) == {'projection_2d', 'add', 'cm_degree_5'}
    _check_run(wd, 1)
    if mode == 'heatmap':              # resume: one more epoch appended
        ttl.main(argv[:5] + ['2'] + argv[6:])
        _check_run(wd, 2)


@pytest.mark.parametrize('mode', ['heatmap', 'pvnet'])
def test_cli_real_layout(data2, tmp_path, mode):
    pkl, root, *_ = data2
    wd = tmp_path / mode
    argv = ['--workdir', str(wd), '--cls', CLS, '--mode', mode,
            '--epochs', '1', '--batch-size', '2', '--crop-size', '32',
            '--pkl-dir', pkl, '--image-root', root, '--frame-h',
            str(FRAME_H), '--frame-w', str(FRAME_W), '--device', 'cpu']
    if mode == 'heatmap':
        argv += ['--occ-pkl-dir', pkl, '--occ-image-root', root]
    else:
        argv += ['--augment']
    res = ttl.main(argv)
    for k in ('projection_2d', 'add', 'cm_degree_5'):
        assert 0.0 <= res[k] <= 1.0
    _check_run(wd, 1, occ=mode == 'heatmap')
    if mode == 'heatmap':
        assert all(0.0 <= res[f'occ_{k}'] <= 1.0
                   for k in ('projection_2d', 'add', 'cm_degree_5'))


def test_real_batch_augment_on_draws():
    """The real-data step's crop and augmentation chain: the draws of
    ``draw_real_augment`` reproduce it, keypoints and mask stay finite and
    binary, the input is ImageNet-normalized."""
    rng = np.random.default_rng(3)
    frames = T(rng.uniform(0, 255, (2, FRAME_H, FRAME_W, 3)).astype(
        np.float32))
    masks = torch.zeros((2, FRAME_H, FRAME_W))
    masks[:, 20:50, 30:70] = 1.0
    boxes = torch.tensor([[30.0, 20.0, 70.0, 50.0], [28.0, 18.0, 72.0, 52.0]])
    kp = T(rng.uniform(30, 50, (2, 5, 2)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = ttl.draw_real_augment(gen, 2, 32)
    a = ttl.real_batch(frames, boxes, kp, masks, 32, True, draws=draws)
    b = ttl.real_batch(frames, boxes, kp, masks, 32, True, draws=draws)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    img, m, k = a
    assert img.shape == (2, 32, 32, 3) and m.shape == (2, 32, 32)
    assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    assert torch.isfinite(k).all() and torch.isfinite(img).all()
    plain, _, _ = ttl.real_batch(frames, boxes, kp, masks, 32)
    assert float(plain.mean()) < 1.0      # (x/255 - mean)/std of U[0, 255]
