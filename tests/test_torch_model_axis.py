"""The ``model`` axis in the port (``parallel/mesh.make_process_mesh``,
``param_sharding``, ``shard_state``, ``gather_state``,
``parallel/tensor_parallel``) against the JAX package's ``param_sharding``
and its jitted train step on a (2, 2) mesh, on the CPU with gloo.

Four processes at (2, 2) run ``hrnet_tiny`` in f32 at batch 8 (4 a data
slice) of 32x32 standard-normal images, with ``min_shard_elems`` at 2^13
so that the rule splits ten convs (the head, the 32- and 64-channel block
convs, two stride-2 fuse convs and a transition), and take three Adam
steps.  Tolerances:
- against one process on the whole batch (the existing two-process
  test's): loss relative 1e-6 at the first step and 1e-5 after,
  ``grad_norm`` 1e-6 at the first step; running statistics atol 1e-5
  after the first step and 5e-5 after the third; parameters within 2 lr
  a step (Adam's m/sqrt(v) saturates at +-1 near zero gradients, so a sum
  reassociated to another sign moves an element up to 2 lr, and the
  later steps start from there);
- ``grad_norm`` after the first step against data parallelism alone,
  (2, 1) on two of the ranks, relative 1e-5 (on these weights (2, 1) is
  itself 3.0e-5 from one process there, and 2.7e-5 in a statistic after
  the third step);
- against JAX's ``jax.jit(train_step)`` with ``in_shardings`` from
  ``param_sharding`` on a (2, 2) mesh (``tests/test_torch_train.py``'s):
  loss relative 1e-5 at the first step and 1e-4 after, ``grad_norm``
  relative 1e-4, parameters within lr and statistics 1e-5 (and relative
  1e-5) after the first step;
- between the ranks: every whole parameter and statistic bit-equal on all
  four, each split slice bit-equal within its data group; the ranks start
  from different parameters (rank r adds r), so this also shows the two
  broadcasts, over the model group in ``shard_state`` and over the data
  group in DistributedDataParallel.
The autograd pair runs over a model group of two processes against one
unsplit conv: output within 1e-6, input and weight gradients within 1e-5
of their norms.  ``gather_state(shard_state(s))`` is ``torch.equal`` to
``s``, Adam's state included.
"""

import json
import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.parallel import make_mesh as jax_make_mesh
from esa_pose_estimation_tpu.parallel import param_sharding as jax_rule
from esa_pose_estimation_tpu.train import state as jstate
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.models.layers import Conv
from esa_pose_estimation_tpu_torch.parallel import mesh as tmesh
from esa_pose_estimation_tpu_torch.parallel.tensor_parallel import Axis
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils.artifact import from_jax_variables


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
MIN_ELEMS = 1 << 13
TRAIN_CFG = dict(batch_size=8, crop_size=32, lr=LR,
                 lr_values=(LR, 1e-4, 1e-5, 1e-6))
# make_mesh's rejections on a group of four, as JAX's on four devices
MESH_CASES = (dict(n_data=2, n_model=3), dict(n_model=3), dict(n_model=5),
              dict(n_data=1, n_model=2), dict(n_data=3, n_model=2))

# One rank of the (2, 2) group: the mesh's checks, the autograd pair, three
# train steps, then shard_state and gather_state on fresh states.
WORKER = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.models.layers import BatchNorm, Conv
    from esa_pose_estimation_tpu_torch.parallel import mesh as tmesh
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from esa_pose_estimation_tpu_torch.utils import config, graphs

    torch.set_num_threads(1)
    root, rank = sys.argv[1], int(sys.argv[2])
    kw = json.loads(sys.argv[3])
    dist.init_process_group('gloo', init_method=f'file://{root}/rendezvous',
                            world_size=4, rank=rank)
    data = torch.load(f'{root}/inputs.pt', weights_only=True)
    out = {'mesh_errors': []}
    for case in kw['mesh_cases']:
        try:
            tmesh.make_mesh(**case)
        except ValueError as e:
            out['mesh_errors'].append(str(e))
    mesh = tmesh.make_mesh(2, 2)
    out['coordinate'] = mesh.coordinate
    out['ranks'] = mesh.ranks

    # the autograd pair: a conv split over the model group of two
    conv = Conv(*data['conv_shape'])
    conv.load_state_dict({'weight': data['conv_w']})
    j, n = mesh.model.index, mesh.model.size
    rows = conv.weight.shape[0] // n
    conv.weight.data = conv.weight.data[j * rows:(j + 1) * rows].clone()
    conv.model_axis = mesh.model
    x = data['conv_x'].clone().requires_grad_(True)
    y = conv(x)
    (y * data['conv_g']).sum().backward()
    out['conv'] = {'y': y.detach(), 'x_grad': x.grad,
                   'w_grad': conv.weight.grad, 'channels_last':
                   y.is_contiguous(memory_format=torch.channels_last)}

    def fresh(perturb=True):
        model = HRNet(config.hrnet_tiny())
        model.load_state_dict(data['init'])
        if perturb and rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(float(rank))
        return model, tstate.create_train_state(
            model, config.TrainConfig(**kw['train_cfg']), 100)

    model, st = fresh()
    tmesh.shard_state(st, mesh, kw['min_elems'])
    out['split'] = [c.weight.shape[0] for c in tmesh.split_convs(model)]
    st.train_model = tmesh.wrap_data_parallel(model, mesh)
    d = mesh.coordinate[0]
    batch = {k: v[4 * d:4 * d + 4] for k, v in data['batch'].items()}
    out['loss'], out['grad_norm'] = [], []
    for step in range(%d):
        m = tstate.train_step(st, batch)
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
        if step == 0:
            out['first'] = tmesh.gather_state(st).model.state_dict()
    out['state'] = tmesh.gather_state(st).model.state_dict()
    out['local'] = {k: v.clone() for k, v in model.state_dict().items()}
    out['split_names'] = tmesh.param_sharding(
        fresh(False)[0], mesh, kw['min_elems'])

    # data parallelism alone on ranks 0 and 1, the same global batch
    mesh21 = tmesh.make_process_mesh(2, 1, ranks=[0, 1])
    if mesh21 is not None:
        model, st = fresh(False)
        tmesh.shard_state(st, mesh21, kw['min_elems'])
        st.train_model = tmesh.wrap_data_parallel(model, mesh21)
        d = mesh21.coordinate[0]
        half = {k: v[4 * d:4 * d + 4] for k, v in data['batch'].items()}
        out['data_parallel'] = {'grad_norm': [
            float(tstate.train_step(st, half)['grad_norm'])
            for _ in range(%d)], 'state': model.state_dict()}

    # gather_state(shard_state(s)) == s, Adam's state included
    model, st = fresh(False)
    tstate.train_step(st, data['batch'])
    want = [t.detach().clone() for t in tstate.state_tensors(st)]
    back = tmesh.gather_state(tmesh.shard_state(st, mesh, kw['min_elems']))
    got = tstate.state_tensors(back)
    out['roundtrip'] = (len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want)))
    out['roundtrip_tensors'] = len(want)
    out['roundtrip_step'] = back.step == st.step == 1

    # a (4, 1) mesh splits nothing
    mesh41 = tmesh.make_process_mesh(4, 1)
    model, st = fresh(False)
    shapes = [p.shape for p in model.parameters()]
    tmesh.shard_state(st, mesh41, kw['min_elems'])
    out['mesh41'] = {
        'split': len(tmesh.split_convs(model)),
        'shapes_kept': shapes == [p.shape for p in model.parameters()],
        'data_group_is_world': mesh41.data.group is None,
        'bn_axis': all(m.data_axis is mesh41.data for m in model.modules()
                       if isinstance(m, BatchNorm))}

    # a storage swap after a capture's pointers were taken
    model, st = fresh(False)
    tstate.train_step(st, data['batch'])
    reads = graphs.tensor_reader([model], grads=True)
    pointers = graphs.storage_pointers(reads())
    tmesh.shard_state(st, mesh, kw['min_elems'])
    try:
        graphs.check_pointers(pointers, graphs.storage_pointers(reads()))
        out['swap'] = 'not raised'
    except RuntimeError as e:
        out['swap'] = str(e)

    # a checkpoint of a split state raises; its gathered state saves
    ck = CheckpointManager(f'{root}/ck{rank}')
    try:
        ck.save('last', st, 0)
        out['save_split'] = 'saved'
    except ValueError as e:
        out['save_split'] = str(e)
    whole = tmesh.gather_state(st)
    ck.save('last', whole, 0)
    out['saved_state'] = whole.model.state_dict()
    torch.save(out, f'{root}/out{rank}.pt')
    dist.destroy_process_group()
''' % (STEPS, STEPS))


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _jax_state(model, variables, cfg):
    return jstate.TrainState.create(
        apply_fn=model.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.adam(jstate.lr_schedule(cfg, 100)))


def _jax_steps(model, variables, batch) -> dict:
    """JAX's train step jitted with the state placed by its
    ``param_sharding`` on a (2, 2) mesh of four host devices and the
    batch over 'data': losses, norms, the states after the first and the
    last step."""
    cfg = jcfg.TrainConfig(**TRAIN_CFG)
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    st = _jax_state(model, variables, cfg)
    shardings = jax_rule(st, mesh, MIN_ELEMS)
    dat = NamedSharding(mesh, P('data'))
    step = jax.jit(partial(jstate.train_step),
                   in_shardings=(shardings, dat),
                   out_shardings=(shardings, NamedSharding(mesh, P())))
    st = jax.tree.map(jax.device_put, st, shardings)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, dat)
    out = {'loss': [], 'grad_norm': [],
           'n_split': sum(int(not s.is_fully_replicated)
                          for s in jax.tree.leaves(shardings))}
    for i in range(STEPS):
        st, metrics = step(st, jb)
        out['loss'].append(float(metrics['loss']))
        out['grad_norm'].append(float(metrics['grad_norm']))
        if i == 0:
            out['first'] = from_jax_variables(jax.tree.map(
                np.asarray, {'params': st.params,
                             'batch_stats': st.batch_stats}))
    return out


def _port_steps(init, batch) -> dict:
    """The same three steps in one process, no group, the whole batch."""
    model = HRNet(tcfg.hrnet_tiny())
    model.load_state_dict(init)
    st = tstate.create_train_state(model, tcfg.TrainConfig(**TRAIN_CFG), 100)
    out = {'loss': [], 'grad_norm': []}
    for i in range(STEPS):
        m = tstate.train_step(st, batch)
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
        if i == 0:
            out['first'] = {k: v.clone() for k, v in
                            model.state_dict().items()}
    out['state'] = model.state_dict()
    return out


@pytest.fixture(scope='module')
def run(tmp_path_factory, one_thread):
    """The four ranks' outputs, and the one-process and JAX references,
    computed while the ranks run."""
    root = tmp_path_factory.mktemp('model_axis')
    jmodel = JaxHRNet(jcfg.hrnet_tiny())
    variables = jax.tree.map(np.array, jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 32, 32, 1)), train=False))(jax.random.PRNGKey(1)))
    b = jsyn.make_batch(jax.random.PRNGKey(0), 8, jsyn.spacecraft_points(6),
                        crop_size=32)
    batch = {k: np.array(b[k]) for k in ('heatmaps', 'weights')}
    # standard-normal images (ROADMAP section 3: fast variance)
    batch['image'] = np.random.default_rng(3).normal(
        size=(8, 32, 32, 1)).astype(np.float32)
    rng = np.random.default_rng(5)
    conv_shape = (6, 8, 3, 2)             # cin, cout, kernel, stride
    inputs = {
        'init': from_jax_variables(variables),
        'batch': {k: torch.from_numpy(v) for k, v in batch.items()},
        'conv_shape': conv_shape,
        'conv_w': torch.from_numpy(rng.normal(size=(8, 6, 3, 3)).astype(
            np.float32)),
        'conv_x': torch.from_numpy(rng.normal(size=(2, 6, 10, 10)).astype(
            np.float32)).contiguous(memory_format=torch.channels_last),
        'conv_g': torch.from_numpy(rng.normal(size=(2, 8, 5, 5)).astype(
            np.float32))}
    torch.save(inputs, root / 'inputs.pt')
    script = root / 'worker.py'
    script.write_text(WORKER)
    kw = json.dumps({'mesh_cases': MESH_CASES, 'min_elems': MIN_ELEMS,
                     'train_cfg': TRAIN_CFG})
    procs = [subprocess.Popen([sys.executable, str(script), str(root),
                               str(r), kw], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        jax_out = _jax_steps(jmodel, variables, batch)
        one = _port_steps(inputs['init'], inputs['batch'])
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(root / f'out{r}.pt', weights_only=False)
             for r in range(4)]
    return {'ranks': ranks, 'one': one, 'jax': jax_out, 'inputs': inputs,
            'root': root}


# --- (a) the rule -----------------------------------------------------------

def _mesh_of(n_model: int) -> tmesh.ProcessMesh:
    """A process mesh's shape and nothing else (no group): what the rule
    reads."""
    ax = Axis(None, n_model, 0)
    return tmesh.ProcessMesh(((0,) * n_model,), (0, 0), Axis(None, 1, 0), ax)


def _jax_split_names(cfg, n_model: int, min_elems: int) -> set[str]:
    model = JaxHRNet(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    mesh = jax_make_mesh(8 // n_model, n_model)
    shardings = jax_rule(shapes['params'], mesh, min_elems)
    split = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(shapes['params'])[0],
            jax.tree.leaves(shardings)):
        if not sh.is_fully_replicated:
            node = split
            keys = [k.key for k in path]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.zeros(leaf.shape, np.float32)
    return set(from_jax_variables({'params': split}))


@pytest.mark.parametrize('name,n_model,min_elems,count', [
    ('hrnet_esa', 2, 1 << 16, 28), ('hrnet_esa', 4, 1 << 16, 28),
    ('hrnet_tiny', 2, 1 << 16, 1), ('hrnet_tiny', 2, MIN_ELEMS, 10)])
def test_rule_selects_jax_leaves(name, n_model, min_elems, count):
    cfg = getattr(tcfg, name)()
    with torch.device('meta'):
        model = HRNet(cfg)
    got = tmesh.param_sharding(model, _mesh_of(n_model), min_elems)
    assert len(got) == count
    assert set(got) == _jax_split_names(getattr(jcfg, name)(), n_model,
                                        min_elems)
    if name == 'hrnet_esa':
        params = dict(model.named_parameters())
        assert sum(params[k].numel() for k in got) == 9_593_856
        assert sum(p.numel() for p in params.values()) == 10_836_632
        assert 'ConvBN_1.Conv_0.weight' in got
    assert tmesh.param_sharding(model, _mesh_of(1), min_elems) == []


# --- (b) the mesh -----------------------------------------------------------

def test_make_mesh_rejects_what_jax_rejects(run):
    four = jax.devices()[:4]
    want = []
    for case in MESH_CASES:
        with pytest.raises(ValueError) as err:
            jax_make_mesh(devices=four, **case)
        want.append(str(err.value))
    for r in run['ranks']:
        assert r['mesh_errors'] == want
    assert want[2] == 'n_model=5 with 4 devices'


def test_process_mesh_is_row_major(run):
    assert [r['coordinate'] for r in run['ranks']] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r['ranks'] == ((0, 1), (2, 3)) for r in run['ranks'])
    assert (jax_make_mesh(2, 2, devices=jax.devices()[:4]).devices.shape
            == (2, 2))


def test_model_axis_needs_a_group():
    with pytest.raises(RuntimeError, match='no process group is joined'):
        tmesh.make_mesh(2, 2)


# --- (c) the autograd pair ---------------------------------------------------

def test_autograd_pair_matches_one_conv(run):
    inp = run['inputs']
    cin, cout, k, stride = inp['conv_shape']
    conv = Conv(cin, cout, k, stride)
    conv.load_state_dict({'weight': inp['conv_w']})
    x = inp['conv_x'].clone().requires_grad_(True)
    y = conv(x)
    (y * inp['conv_g']).sum().backward()
    for r in run['ranks'][:2]:
        got = r['conv']
        assert got['channels_last']
        np.testing.assert_allclose(got['y'].numpy(), y.detach().numpy(),
                                   atol=1e-6, rtol=0)
        gx = x.grad.numpy()
        np.testing.assert_allclose(got['x_grad'].numpy(), gx, rtol=0,
                                   atol=1e-5 * np.linalg.norm(gx))
    # each rank's slice of the weight gradient, at 1x and not n_model x
    rows = cout // 2
    for j, r in enumerate(run['ranks'][:2]):
        want = conv.weight.grad[j * rows:(j + 1) * rows].numpy()
        np.testing.assert_allclose(r['conv']['w_grad'].numpy(), want,
                                   rtol=0,
                                   atol=1e-5 * np.linalg.norm(want))


# --- (d) three steps at (2, 2) ---------------------------------------------

def test_split_convs_are_the_rules(run):
    for r in run['ranks']:
        assert len(r['split_names']) == 10
        assert len(r['split']) == 10       # each conv holds half its rows
    local = run['ranks'][0]['local']
    whole = run['inputs']['init']
    for name in run['ranks'][0]['split_names']:
        assert local[name].shape[0] * 2 == whole[name].shape[0]


def test_four_processes_match_one_process(run):
    one = run['one']
    for r in run['ranks']:
        for step in range(STEPS):
            rel = 1e-6 if step == 0 else 1e-5
            assert r['loss'][step] == pytest.approx(one['loss'][step],
                                                    rel=rel), step
        assert r['grad_norm'][0] == pytest.approx(one['grad_norm'][0],
                                                  rel=1e-6)
    got = run['ranks'][0]
    for k, want in one['first'].items():
        tol = 1e-5 if 'running' in k else 2 * LR
        np.testing.assert_allclose(got['first'][k].numpy(), want.numpy(),
                                   atol=tol, rtol=0, err_msg=k)
    for k, want in one['state'].items():
        tol = 5e-5 if 'running' in k else 2 * LR * STEPS
        np.testing.assert_allclose(got['state'][k].numpy(), want.numpy(),
                                   atol=tol, rtol=0, err_msg=k)


def test_later_norms_match_data_parallelism(run):
    """After the first step the gradients' norm is held to data
    parallelism alone, (2, 1) on ranks 0 and 1 on the same global batch,
    at 1e-5: on these weights (2, 1) is itself 3.0e-5 from one process in
    the second step's norm (and 2.7e-5 in a running statistic after the
    third, hence the statistics' 5e-5 there), since the first step's
    elements near zero gradient move up to 2 lr apart (Adam's saturation,
    above) and the later steps start from there."""
    ref = run['ranks'][0]['data_parallel']
    assert ref['grad_norm'][0] == pytest.approx(run['one']['grad_norm'][0],
                                                rel=1e-6)
    for r in run['ranks']:
        for step in range(1, STEPS):
            assert r['grad_norm'][step] == pytest.approx(
                ref['grad_norm'][step], rel=1e-5), step


def test_four_processes_match_jax_sharded_step(run):
    jx = run['jax']
    assert jx['n_split'] == 3 * 10      # the kernels and both moments
    for r in run['ranks']:
        for step in range(STEPS):
            rel = 1e-5 if step == 0 else 1e-4
            assert r['loss'][step] == pytest.approx(jx['loss'][step],
                                                    rel=rel), step
        assert r['grad_norm'][0] == pytest.approx(jx['grad_norm'][0],
                                                  rel=1e-4)
    first = run['ranks'][0]['first']
    for k, want in jx['first'].items():
        tol = LR if 'running' not in k else 1e-5
        np.testing.assert_allclose(first[k].numpy(), want.numpy(), atol=tol,
                                   rtol=1e-5, err_msg=k)


def test_replicas_are_bit_equal(run):
    ranks = run['ranks']
    split = set(ranks[0]['split_names'])
    moved = 0
    for k, v in ranks[0]['local'].items():
        if k in split:
            # the data groups {0, 2} and {1, 3} hold one slice each
            assert torch.equal(v, ranks[2]['local'][k]), k
            assert torch.equal(ranks[1]['local'][k], ranks[3]['local'][k])
            assert not torch.equal(v, ranks[1]['local'][k]), k
        else:
            for r in ranks[1:]:
                assert torch.equal(v, r['local'][k]), k
        moved += not torch.equal(v, run['inputs']['init'][k])
    assert moved > 0
    for when in ('first', 'state'):
        for k, v in ranks[0][when].items():
            assert all(torch.equal(v, r[when][k]) for r in ranks[1:]), k


# --- (e)-(h) -----------------------------------------------------------------

def test_gather_inverts_shard(run):
    for r in run['ranks']:
        assert r['roundtrip'] and r['roundtrip_step']
        assert r['roundtrip_tensors'] > 3 * 10


def test_mesh_4x1_splits_nothing(run):
    for r in run['ranks']:
        assert r['mesh41'] == {'split': 0, 'shapes_kept': True,
                               'data_group_is_world': True, 'bn_axis': True}


def test_storage_swap_after_capture_raises(run):
    for r in run['ranks']:
        assert 'replaced since' in r['swap'], r['swap']


def test_save_writes_whole_tensors(run):
    whole = run['inputs']['init']
    for r, out in enumerate(run['ranks']):
        assert 'split over a model axis' in out['save_split']
        saved = torch.load(run['root'] / f'ck{r}' / 'last',
                           weights_only=True)
        assert {k: v.shape for k, v in saved['model'].items()} == {
            k: v.shape for k, v in whole.items()}
        for k, v in out['saved_state'].items():
            assert torch.equal(saved['model'][k], v), k
        assert len(saved['optimizer']['state']) == len(whole) - sum(
            'running' in k for k in whole)
