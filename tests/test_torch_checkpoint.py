"""The port's checkpoints, logs and weight carry against the JAX package,
and the training command end to end on the CPU.

Tolerances:
- a checkpoint saved and restored, in the port's own format: every tensor
  of the model and of the optimizer ``torch.equal``, and the next step's
  loss and parameters too;
- an orbax train state written by the JAX ``CheckpointManager`` after two
  Adam steps, carried into the port (``from_jax_variables``,
  ``from_jax_adam``) and through a port checkpoint: the next step's loss
  rtol 1e-5 against the JAX step's, the parameters after it within lr
  (as in ``test_torch_train``), the running statistics 1e-5; the Adam
  moments carried back (``to_jax_variables``) equal to the bit;
- logs: ``TsvLogger``, ``JsonlLogger`` and ``TbWriter`` files byte-equal
  to the JAX copies' at a fixed wall time;
- an npz exported from a port checkpoint and read by the JAX package's
  ``load_inference_artifact``: its heatmaps atol 1e-5 against the port's
  on the same artifact (f32 both);
- ``cli.train --tiny --device cpu``: a run that fails in epoch 2 and
  resumes from ``last`` ends on weights ``torch.equal`` to an unbroken
  run's.
"""

import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.obs import logger as jlogger
from esa_pose_estimation_tpu.obs import tbevents as jtb
from esa_pose_estimation_tpu.train import checkpoint as jckpt
from esa_pose_estimation_tpu.train import state as jstate
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu.utils.artifact import load_inference_artifact
from esa_pose_estimation_tpu_torch.cli import train as ttrain
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.obs import logger as tlogger
from esa_pose_estimation_tpu_torch.obs import tbevents as ttb
from esa_pose_estimation_tpu_torch.train import checkpoint as tckpt
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import artifact as tart
from esa_pose_estimation_tpu_torch.utils import config as tcfg


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3
TRAIN_CFG = dict(batch_size=8, crop_size=32, lr=LR,
                 lr_values=(LR, 1e-4, 1e-5, 1e-6))


def _port_state(seed=0):
    """hrnet_tiny in f32 from the port's own initialiser, with Adam."""
    model = HRNet(tcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(seed))
    return tstate.create_train_state(model, tcfg.TrainConfig(**TRAIN_CFG),
                                     100)


def _port_batch(seed):
    return tsyn.make_batch(torch.Generator().manual_seed(seed), 8,
                           tsyn.spacecraft_points(n=6), crop_size=32)


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa['param_groups'] == ob['param_groups']
    assert set(oa['state']) == set(ob['state'])
    for i, st in oa['state'].items():
        assert all(torch.equal(v, ob['state'][i][k]) for k, v in st.items())
    assert a.step == b.step


def test_checkpoint_round_trip(tmp_path):
    st = _port_state()
    for seed in (1, 2):
        tstate.train_step(st, _port_batch(seed))
    mgr = tckpt.CheckpointManager(str(tmp_path / 'net_esa'))
    mgr.save(tckpt.LAST, st, epoch=4)
    assert sorted(os.listdir(tmp_path / 'net_esa')) == ['last']
    back, next_epoch = mgr.restore(tckpt.LAST, _port_state(seed=9))
    assert next_epoch == 5 and back.step == 2
    _assert_states_equal(back, st)
    # the restored state goes on as the saved one would have
    m1 = tstate.train_step(st, _port_batch(3))
    m2 = tstate.train_step(back, _port_batch(3))
    assert torch.equal(m1['loss'], m2['loss'])
    _assert_states_equal(back, st)


def test_restore_falls_back_to_old_and_absent_is_epoch_zero(tmp_path):
    st = _port_state()
    tstate.train_step(st, _port_batch(1))
    d = tmp_path / 'net_esa'
    mgr = tckpt.CheckpointManager(str(d))
    fresh = _port_state(seed=5)
    assert mgr.restore(tckpt.LAST, fresh) == (fresh, 0)
    assert not d.exists()                 # a restore creates nothing
    mgr.save(tckpt.LAST, st, epoch=0)
    # the crash window of a second save: the old file renamed away, the
    # new one not yet in
    os.replace(d / 'last', d / 'last.old')
    (d / 'last.new').write_bytes(b'partial')
    assert mgr.exists(tckpt.LAST)
    back, next_epoch = mgr.restore(tckpt.LAST, _port_state(seed=7))
    assert next_epoch == 1
    _assert_states_equal(back, st)
    # the next save completes the swap and clears both leftovers
    mgr.save(tckpt.LAST, st, epoch=1)
    assert sorted(os.listdir(d)) == ['last']


def test_restore_required_names_what_is_there(tmp_path):
    d = tmp_path / 'net_esa'
    mgr = tckpt.CheckpointManager(str(d))
    with pytest.raises(FileNotFoundError, match=r'available: \[\]'):
        mgr.restore_required(tckpt.BEST_ROTATE, _port_state())
    mgr.save(tckpt.LAST, _port_state(), epoch=0)
    with pytest.raises(FileNotFoundError) as e:
        mgr.restore_required(tckpt.BEST_ROTATE, _port_state())
    assert "checkpoint 'best_rotate' not found under" in str(e.value)
    assert "(available: ['last'])" in str(e.value)
    _, next_epoch = mgr.restore_required(tckpt.LAST, _port_state())
    assert next_epoch == 1


def test_best_gates_and_sidecar_match_jax(tmp_path, monkeypatch):
    """The same eval scores through both ``save_rolling``s: the same
    aliases saved at the same epochs, the same running minima, the same
    sidecar bytes, and a resumed manager that reads them back."""
    saved = {'jax': [], 'port': []}
    monkeypatch.setattr(jckpt.CheckpointManager, 'save',
                        lambda self, name, st, epoch:
                        saved['jax'].append((name, epoch)))
    monkeypatch.setattr(tckpt.CheckpointManager, 'save',
                        lambda self, name, st, epoch:
                        saved['port'].append((name, epoch)))
    jm = jckpt.CheckpointManager(str(tmp_path / 'jax'))
    tm = tckpt.CheckpointManager(str(tmp_path / 'port'))
    scores = [(0.5, 0.4), (0.6, 0.3), (0.2, 0.35), (0.2, 0.1), (0.7, 0.9)]
    bests = {'jax': {}, 'port': {}}
    for epoch, (t, r) in enumerate(scores):
        for key, m in (('jax', jm), ('port', tm)):
            bests[key] = m.save_rolling(None, epoch, score_tran=t,
                                        score_rotate=r, best=bests[key],
                                        save_last=epoch % 2 == 0)
    assert saved['port'] == saved['jax']
    assert (tckpt.BEST_TRAN, 2) in saved['port']
    assert bests['port'] == bests['jax'] == {'best_tran': 0.2,
                                             'best_rotate': 0.1}
    side = [open(tmp_path / k / 'best_scores.json', 'rb').read()
            for k in ('jax', 'port')]
    assert side[0] == side[1]
    assert tckpt.CheckpointManager(str(tmp_path / 'port')).load_best() == \
        bests['jax']


@pytest.fixture(scope='module')
def jax_tiny():
    """hrnet_tiny's JAX variables, and a jitted train step of the JAX
    package's ``train_step``."""
    model = JaxHRNet(jcfg.hrnet_tiny())
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 1)), train=False))(jax.random.PRNGKey(1))
    return model, variables, jax.jit(jstate.train_step)


def _jax_batch(seed):
    """JAX targets on standard-normal images: on the synthetic crops' flat
    ground the fast variance of JAX's f32 sums drifts (see the ``tiny``
    fixture of ``test_torch_train``)."""
    b = jsyn.make_batch(jax.random.PRNGKey(seed), 8,
                        jsyn.spacecraft_points(6), crop_size=32)
    image = np.random.default_rng(seed).normal(size=(8, 32, 32, 1))
    return {'image': jnp.asarray(image, jnp.float32),
            'heatmaps': b['heatmaps'], 'weights': b['weights']}


def test_orbax_checkpoint_resumes_in_port(tmp_path, jax_tiny):
    model, variables, step = jax_tiny
    cfg = jcfg.TrainConfig(**TRAIN_CFG)
    st = jstate.TrainState.create(
        apply_fn=model.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.adam(jstate.lr_schedule(cfg, 100)))
    template = st
    for seed in (1, 2):
        st, _ = step(st, _jax_batch(seed))
    wd = str(tmp_path / 'jax' / 'net_esa')
    jckpt.CheckpointManager(wd).save('last', st, 3)
    b3 = _jax_batch(3)
    st_next, metrics = step(st, b3)

    # the orbax read, in the test; the port takes numpy trees from there
    got, next_epoch = jckpt.CheckpointManager(wd).restore('last', template)
    got = jax.device_get(got)
    adam = got.opt_state[0]
    port = tstate.create_train_state(HRNet(tcfg.hrnet_tiny()),
                                     tcfg.TrainConfig(**TRAIN_CFG), 100)
    port.model.load_state_dict(tart.from_jax_variables(
        {'params': got.params, 'batch_stats': got.batch_stats}), strict=True)
    port.optimizer.load_state_dict(tart.from_jax_adam(
        adam.mu, adam.nu, int(adam.count), port.model, port.optimizer))
    port.step = int(adam.count)
    carried = tart.to_jax_variables(port.model, port.optimizer)
    for a, b in ((carried['adam']['mu'], adam.mu),
                 (carried['adam']['nu'], adam.nu),
                 (carried['params'], got.params),
                 (carried['batch_stats'], got.batch_stats)):
        jax.tree.map(np.testing.assert_array_equal, a, jax.tree.map(
            np.asarray, b))
    assert carried['adam']['count'] == 2

    # through the port's own checkpoint format, then one step
    mgr = tckpt.CheckpointManager(str(tmp_path / 'port' / 'net_esa'))
    mgr.save(tckpt.LAST, port, next_epoch - 1)
    resumed, epoch = mgr.restore(
        tckpt.LAST, tstate.create_train_state(
            HRNet(tcfg.hrnet_tiny()), tcfg.TrainConfig(**TRAIN_CFG), 100))
    assert epoch == next_epoch == 4 and resumed.step == 2
    m = tstate.train_step(resumed, {k: torch.from_numpy(np.array(v))
                                    for k, v in b3.items()})
    assert float(m['loss']) == pytest.approx(float(metrics['loss']),
                                             rel=1e-5)
    want = tart.from_jax_variables(jax.tree.map(np.asarray, {
        'params': st_next.params, 'batch_stats': st_next.batch_stats}))
    sd = resumed.model.state_dict()
    for k, w in want.items():
        tol = 1e-5 if 'running' in k else LR
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=tol,
                                   rtol=1e-5, err_msg=k)


def test_loggers_write_the_jax_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, 'time', lambda: 1_760_000_000.25)
    out = {}
    for key, lg, tb in (('jax', jlogger, jtb), ('port', tlogger, ttb)):
        d = tmp_path / key
        tsv = lg.TsvLogger(str(d / 'log_esa.txt'), resume=True)
        tsv.set_names(['Epoch', 'LR', 'Train Loss'])
        tsv.append([1, 1e-4, 0.0123456789])
        tsv.close()
        # a resumed log keeps its header and appends
        tsv = lg.TsvLogger(str(d / 'log_esa.txt'), resume=True)
        tsv.set_names(['Epoch', 'LR', 'Train Loss'])
        tsv.append([2, 1e-5, float('nan')])
        tsv.close()
        ev = lg.JsonlLogger(str(d / 'events.jsonl'))
        ev.log('epoch', epoch=1, lr=1e-4, loss=0.5, seconds=1.25)
        ev.log('eval', epoch=1, score_t=0.1, nonfinite=0)
        ev.close()
        w = tb.TbWriter(str(d / 'tb'))
        w.scalars(1, {'train/loss': 0.5, 'train/lr': 1e-4})
        w.scalar(2, 'eval/speed', 0.01, wall_time=1_760_000_001.5)
        w.close()
        (tb_file,) = glob.glob(str(d / 'tb' / 'events.out.tfevents.*'))
        out[key] = [open(p, 'rb').read() for p in
                    (d / 'log_esa.txt', d / 'events.jsonl', tb_file)]
        out[key].append(os.path.basename(tb_file))
    assert out['port'] == out['jax']
    rows = ttb.read_scalars(glob.glob(str(tmp_path / 'port' / 'tb' / '*'))[0])
    assert rows == jtb.read_scalars(
        glob.glob(str(tmp_path / 'jax' / 'tb' / '*'))[0])
    assert {t for _, t, _ in rows} == {'train/loss', 'train/lr',
                                       'eval/speed'}
    assert json.loads(out['port'][1].splitlines()[1])['event'] == 'eval'
    # a TCP pusher with no host stays off and never raises
    p = tlogger.TcpPusher()
    assert not p.create_socket() and not p.send('x')
    p.close()


def test_exported_artifact_loads_in_jax(tmp_path):
    """A port checkpoint (after two train steps, so the running
    statistics are not the initial ones) -> ``utils.artifact`` npz -> the
    JAX package's loader and model, against the port's loader."""
    st = _port_state()
    for seed in (1, 2):
        tstate.train_step(st, _port_batch(seed))
    wd = tmp_path / 'run'
    tckpt.CheckpointManager(str(wd / 'net_esa')).save(tckpt.BEST_ROTATE, st,
                                                      6)
    npz = str(tmp_path / 'out' / 'tiny.npz')
    assert tart.main(['--workdir', str(wd), '--out', npz, '--tiny',
                      '--crop-size', '32', '--device', 'cpu']) == npz
    variables, meta = load_inference_artifact(npz)
    assert meta == {'checkpoint': 'best_rotate', 'epoch': 6,
                    'model': 'hrnet_tiny', 'crop_size': 32}
    port_vars, port_meta = tart.read_artifact(npz)
    assert port_meta == meta
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, variables), port_vars)
    # the bf16 parameters and f32 statistics the artifact carries
    sd = st.model.state_dict()
    got = tart.from_jax_variables(port_vars)
    for k, v in sd.items():
        want = v if 'running' in k else v.to(torch.bfloat16).float()
        assert torch.equal(got[k], want), k
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    want = jax.jit(lambda v, x: JaxHRNet(jcfg.hrnet_tiny()).apply(
        v, x, train=False))(variables, jnp.asarray(x))
    model = tart.load_hrnet_artifact(npz, dtype=torch.float32, device='cpu')
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


TRAIN_ARGS = ['--tiny', '--epochs', '2', '--batch-size', '8',
              '--crop-size', '32', '--synthetic-size', '16', '--device',
              'cpu', '--log-every', '1']


def test_cli_train_resumes_where_it_failed(tmp_path, monkeypatch):
    """Two epochs of two steps, evaluated every epoch; then the same run
    failing at the first batch of epoch 2 and retried: it resumes from
    ``last`` at epoch 2 and ends on the unbroken run's weights."""
    whole = str(tmp_path / 'whole')
    result = ttrain.main(['--workdir', whole, '--eval-every', '1', '--tb']
                         + TRAIN_ARGS)
    assert set(result) >= {'score_t', 'score_r', 'speed', 'nonfinite'}
    names = sorted(os.listdir(os.path.join(whole, 'net_esa')))
    assert {'last', 'best_scores.json'} <= set(names)
    assert 'best_rotate' in names or not np.isfinite(result['score_r'])
    rows = open(os.path.join(whole, 'log_esa.txt')).read().split('\n')
    assert rows[0] == 'Epoch\tLR\tTrain Loss'
    assert [r.split('\t')[0] for r in rows[1:3]] == ['1', '2']
    assert all(np.isfinite(float(r.split('\t')[2])) for r in rows[1:3])
    events = [json.loads(line)['event'] for line in
              open(os.path.join(whole, 'events.jsonl'))]
    assert events == ['epoch', 'eval_cache', 'eval', 'epoch', 'eval']
    (tb,) = glob.glob(os.path.join(whole, 'tb', 'events.out.tfevents.*'))
    assert {s for s, t, _ in ttb.read_scalars(tb) if t == 'eval/speed'} == \
        {1, 2}

    calls = {'n': 0}
    real = tsyn.make_batch

    def flaky(*a, **k):
        calls['n'] += 1
        if calls['n'] == 3:            # the first batch of epoch 2
            raise RuntimeError('injected failure')
        return real(*a, **k)
    monkeypatch.setattr(tsyn, 'make_batch', flaky)
    broken = str(tmp_path / 'broken')
    ttrain.main(['--workdir', broken, '--eval-every', '100',
                 '--max-retries', '1'] + TRAIN_ARGS)
    assert calls['n'] == 5
    rows = open(os.path.join(broken, 'log_esa.txt')).read().split('\n')
    assert [r.split('\t')[0] for r in rows[1:-1]] == ['1', '2']

    def restore(wd):
        return tckpt.CheckpointManager(os.path.join(wd, 'net_esa')).restore(
            tckpt.LAST, tstate.create_train_state(
                HRNet(tcfg.hrnet_tiny(), dtype=torch.bfloat16),
                tcfg.TrainConfig(), 2))
    a, ea = restore(whole)
    b, eb = restore(broken)
    assert ea == eb == 2 and a.step == b.step == 4
    _assert_states_equal(a, b)


def test_cli_train_pickle_route(tmp_path):
    """--train-pkl/--test-pkl/--image-root: a labelled PNG split read
    through data/speed.BatchLoader, prefetched, built into batches with
    both augmentations, evaluated every epoch."""
    import pickle

    from PIL import Image

    from esa_pose_estimation_tpu_torch.core import camera
    pts = tsyn.spacecraft_points(n=6)
    s = tsyn.make_sample(torch.Generator().manual_seed(4), pts, 4)
    recs = []
    for i in range(4):
        name = f'img{i:06d}.png'
        Image.fromarray(s.image[i].numpy().astype(np.uint8)).save(
            tmp_path / name)
        R = camera.quat_to_rotmat(s.quat[i]).numpy()
        recs.append({'rgb_pth': name, 'bbox': s.bbox[i].numpy(),
                     'sift': s.keypoints_2d[i].numpy(),
                     'sift3d': pts.numpy(), 'K': camera.SPEED_K,
                     'RT': np.concatenate([R, s.trans[i].numpy()[:, None]],
                                          1),
                     'qua': s.quat[i].numpy()})
    with open(tmp_path / 'split.pkl', 'wb') as f:
        pickle.dump(recs, f)
    wd = str(tmp_path / 'run')
    result = ttrain.main(['--workdir', wd, '--tiny', '--epochs', '1',
                          '--batch-size', '2', '--crop-size', '32',
                          '--train-pkl', str(tmp_path / 'split.pkl'),
                          '--test-pkl', str(tmp_path / 'split.pkl'),
                          '--image-root', str(tmp_path), '--eval-every',
                          '1', '--augment-geom', '--augment-photo',
                          '--no-shuffle', '--device', 'cpu'])
    assert 0 <= result['nonfinite'] <= 4 and 'speed' in result
    rows = open(os.path.join(wd, 'log_esa.txt')).read().split('\n')
    assert rows[1].split('\t')[0] == '1'
    assert np.isfinite(float(rows[1].split('\t')[2]))
    events = [json.loads(line) for line in open(os.path.join(
        wd, 'events.jsonl'))]
    assert [e['event'] for e in events] == ['epoch', 'eval_cache', 'eval']
    assert events[1]['frames'] == 4
    _, next_epoch = tckpt.CheckpointManager(os.path.join(wd, 'net_esa')
                                            ).restore(
        tckpt.LAST, tstate.TrainState(HRNet(tcfg.hrnet_tiny())))
    assert next_epoch == 1
