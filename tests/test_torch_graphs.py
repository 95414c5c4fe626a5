"""The compiled programs of the port (``utils/graphs.py``,
``pipeline.make_jitted_pipeline``, ``EvalCache.infer``,
``train/state.make_scan_step``) on the CPU, where they run eagerly
through the same entry points, and the four public functions that joined
them.  The graphs themselves run on the card only (``chip_smoke.py``
phase 20).

Tolerances:
- RANSAC uniforms in place of the generator's draw, the jitted pipeline
  and the graphed eval tail against eager calls, the scan against the
  port's own per-step loop: ``torch.equal`` (the same operations);
- the scan (``n_inner`` = 2, ``hrnet_tiny`` in f32) against the JAX
  ``make_sharded_scan_step`` on a one-device mesh, fed JAX's batches:
  the first step's loss 1e-5 relative and the second's 1e-4 (measured
  7.3e-5: the first update moves near-zero-gradient elements by up to lr
  in either framework, since a reassociated sum may flip the sign of
  their m/sqrt(v), and the second loss reads them; ``test_torch_train.py``
  holds later losses at 1e-4 for the same reason), parameters and
  running statistics within 2 n lr (the second forward's batch statistics
  read those parameters: measured 1.3e-4 at most);
- ``quat_to_dcm`` atol 1e-6; ``epnp``/``epnp_single`` on the fixtures of
  ``tests/test_pnp.py``: rotation within 1e-3 rad of JAX's and
  translation within 1e-3 relative (the pipeline's pose tolerance: two
  f32 programs of inverse iteration and Newton polar steps), plus the
  JAX test's ground-truth bounds; ``crop_resize_single`` atol 1e-3 on
  0-255 values (``test_torch_crop.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

from esa_pose_estimation_tpu.core import camera as jcamera
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.ops import crop as jcrop
from esa_pose_estimation_tpu.ops import epnp as jepnp
from esa_pose_estimation_tpu.parallel.mesh import make_mesh, replicate
from esa_pose_estimation_tpu.train import state as jstate
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch import pipeline
from esa_pose_estimation_tpu_torch.core import camera as tcamera
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.eval.eval_cache import EvalCache
from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import fused_cbam
from esa_pose_estimation_tpu_torch.models import layers
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.ops import crop as tcrop
from esa_pose_estimation_tpu_torch.ops import epnp as tepnp
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp
from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import peak_decode
from esa_pose_estimation_tpu_torch.train import checkpoint as tckpt
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils import graphs
from esa_pose_estimation_tpu_torch.utils.artifact import from_jax_variables


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEED_K = np.asarray(jcamera.SPEED_K, np.float32)
LR = 1e-3
TRAIN_CFG = dict(batch_size=8, crop_size=32, lr=LR,
                 lr_values=(LR, 1e-4, 1e-5, 1e-6))
N_INNER = 2


def T(a):
    return torch.from_numpy(np.array(a))


def _assert_outputs_equal(a, b):
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


# --- RANSAC uniforms ---------------------------------------------------------

def _problem(n=30, seed=0, noise_px=0.0, spread=0.5, depth=10.0):
    """``tests/test_pnp.py``'s synthetic_problem: a random pose, its
    projected points under the SPEED camera."""
    rng = np.random.default_rng(seed)
    pts3d = rng.uniform(-spread, spread, size=(n, 3))
    R = Rotation.random(random_state=rng).as_matrix()
    t = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                  depth + rng.uniform(-2, 2)])
    cam = pts3d @ R.T + t
    uv = cam[:, :2] / cam[:, 2:3]
    uv = uv * [SPEED_K[0, 0], SPEED_K[1, 1]] + [SPEED_K[0, 2], SPEED_K[1, 2]]
    uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    return (pts3d.astype(np.float32), uv.astype(np.float32),
            R.astype(np.float32), t.astype(np.float32))


def test_ransac_uniforms_replace_the_generator():
    probs = [_problem(seed=s, noise_px=1.0) for s in range(3)]
    p3 = torch.from_numpy(np.stack([p[0] for p in probs]))
    p2 = torch.from_numpy(np.stack([p[1] for p in probs]))
    p2[:, :4] += 200.0                                     # outliers
    valid = torch.ones(p3.shape[:2], dtype=torch.bool)
    valid[1, 5:9] = False
    K = torch.from_numpy(SPEED_K)
    kw = dict(valid=valid, n_hypotheses=16, lm_iters=3)
    want = tpnp.ransac_epnp(p3, p2, K, torch.Generator().manual_seed(5), **kw)
    u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(5), (3,), 30,
                                  16)
    assert u.shape == (3, 16, 30)
    got = tpnp.ransac_epnp(p3, p2, K, uniforms=u, **kw)
    _assert_outputs_equal(want, got)
    assert not want.inliers[:, :4].any()


@pytest.fixture(scope='module')
def tiny_serving():
    torch.manual_seed(0)
    model = HRNet(tcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(3)).eval()
    pts = tsyn.spacecraft_points(n=6)
    s = tsyn.make_sample(torch.Generator().manual_seed(4), pts, 2,
                         height=240, width=384)
    K = tsyn.scaled_intrinsics(240, 384)
    kw = dict(K=K, crop_size=32, min_keypoints=0, n_hypotheses=8,
              lm_iters=2)
    return model, pts, s, kw


def test_infer_poses_uniforms_and_jitted_pipeline(tiny_serving):
    """infer_poses drawing from a generator, fed the same draw as
    uniforms, and make_jitted_pipeline (eager on CPU tensors) all agree
    exactly."""
    model, pts, s, kw = tiny_serving
    want = pipeline.infer_poses(model, s.image, s.bbox, pts,
                                torch.Generator().manual_seed(9), **kw)
    u = tpnp.draw_ransac_uniforms(torch.Generator().manual_seed(9), (2,), 6,
                                  8)
    _assert_outputs_equal(want, pipeline.infer_poses(
        model, s.image, s.bbox, pts, ransac_uniforms=u, **kw))
    jitted = pipeline.make_jitted_pipeline(model, pts, **kw)
    _assert_outputs_equal(want, jitted(s.image, s.bbox,
                                       torch.Generator().manual_seed(9)))
    assert jitted.graphs.entries == {}          # the CPU runs eagerly


def test_eval_cache_infer_equals_eager(tiny_serving):
    model, pts, s, kw = tiny_serving
    batches = [{'frame': s.image, 'bbox': s.bbox, 'quat': s.quat,
                'trans': s.trans}]
    cache = EvalCache(model, batches, pts, crop_size=32, n_hypotheses=8,
                      frame_hw=(240, 384))
    b = cache.batches[0]
    got = cache.infer(model, b, torch.Generator().manual_seed(2))
    want = pipeline.infer_poses_from_crops(
        model, b['crop'], b['rate'], b['origin'], cache.points_3d,
        torch.Generator().manual_seed(2), **cache.infer_kw)
    _assert_outputs_equal(want, got)
    assert cache.graphs.entries == {}


# --- the graph key -----------------------------------------------------------

def test_graph_key_follows_every_input_and_lever(monkeypatch):
    model = torch.nn.Linear(2, 2)
    x = torch.zeros(4, 3)
    base = graphs.graph_key((model, x), {'n_hypotheses': 8, 'K': None})
    assert base == graphs.graph_key((model, torch.ones(4, 3)),
                                    {'K': None, 'n_hypotheses': 8})
    changed = [
        graphs.graph_key((model, torch.zeros(5, 3)),
                         {'n_hypotheses': 8, 'K': None}),
        graphs.graph_key((model, x.double()), {'n_hypotheses': 8, 'K': None}),
        graphs.graph_key((model, x), {'n_hypotheses': 16, 'K': None}),
        graphs.graph_key((model, x), {'n_hypotheses': 8,
                                      'K': torch.eye(3)}),
        graphs.graph_key((model, x), {'n_hypotheses': 8}),
        graphs.graph_key((torch.nn.Linear(2, 2), x),
                         {'n_hypotheses': 8, 'K': None}),
        graphs.graph_key((model.eval(), x), {'n_hypotheses': 8, 'K': None}),
    ]
    model.train()
    monkeypatch.setattr(layers, 'FUSED_CBAM', True)
    changed.append(graphs.graph_key((model, x),
                                    {'n_hypotheses': 8, 'K': None}))
    monkeypatch.setattr(layers, 'FUSED_CBAM', False)
    assert len({base, *changed}) == len(changed) + 1
    with pytest.raises(TypeError, match='cannot draw'):
        graphs.graph_key((x,), {'generator': torch.Generator()})
    with pytest.raises(TypeError):                  # an unhashable leaf
        graphs.graph_key((x,), {'bad': {1, 2}})


def test_graphed_runs_eagerly_on_the_cpu():
    calls = []

    def fn(a, b, scale=1.0):
        calls.append(a.shape)
        return {'sum': (a + b) * scale, 'n': 1}
    g = graphs.Graphed(fn)
    out = g(torch.ones(2), torch.ones(2), scale=2.0)
    assert calls == [(2,)] and out['n'] == 1
    assert torch.equal(out['sum'], torch.full((2,), 4.0))
    assert g.entries == {} and g.stats() == []


def test_tree_helpers():
    out = pipeline.PoseOutput(*[torch.full((1,), float(i)) for i in range(9)])
    tree = {'a': [out, (torch.zeros(2), None)], 'b': 3}
    leaves = graphs.tensors_of(tree)
    assert len(leaves) == 10 and leaves[0] is out.quat
    doubled = graphs.tree_map(lambda t: t * 2, tree)
    assert isinstance(doubled['a'][0], pipeline.PoseOutput)
    assert float(doubled['a'][0].origins) == 16.0 and doubled['b'] == 3
    assert doubled['a'][1][1] is None


def test_counted_wrappers_are_the_kernels():
    counts = graphs._counts()
    assert [c[:2] for c in counts[:2]] == [('k1', peak_decode),
                                           ('k2', fused_cbam)]
    assert [label for label, _, _ in counts] == [
        'k1', 'k2', 'k3', 'ransac_epnp', 'lm_dual', 'sdpa', 'sdpa_tokens']
    assert all(isinstance(getattr(c, n), int) for _, c, n in counts)


# --- the scan ----------------------------------------------------------------

@pytest.fixture(scope='module')
def scan_setup():
    """hrnet_tiny's JAX initial variables and N_INNER batches of 8 (crop
    32) as the JAX scan makes them from its key stream: JAX heatmap and
    weight targets, standard-normal images (``test_torch_train.py``'s
    reason: on the synthetic crops' flat ground the fast variance
    amplifies JAX's f32 summation error)."""
    model = JaxHRNet(jcfg.hrnet_tiny())
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 1)), train=False))(jax.random.PRNGKey(1))
    pts = jsyn.spacecraft_points(6)

    def batch_fn(k):
        b = jsyn.make_batch(k, 8, pts, crop_size=32)
        return {'image': jax.random.normal(k, (8, 32, 32, 1)),
                'heatmaps': b['heatmaps'], 'weights': b['weights']}
    ekey = jax.random.PRNGKey(42)
    batches = [jax.tree.map(np.array, jax.jit(batch_fn)(
        jax.random.fold_in(ekey, j))) for j in range(N_INNER)]
    return model, jax.tree.map(np.array, variables), batch_fn, ekey, batches


def _port_state(variables):
    model = HRNet(tcfg.hrnet_tiny())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return tstate.create_train_state(model, tcfg.TrainConfig(**TRAIN_CFG),
                                     100)


def _feed(batches):
    """A BatchFn whose draws are the given batches, in turn."""
    it = iter(batches)
    return tstate.BatchFn(
        draw=lambda g: {k: torch.from_numpy(v) for k, v in next(it).items()},
        make=lambda d: d)


def test_scan_matches_jax_scan(scan_setup):
    jmodel, variables, batch_fn, ekey, batches = scan_setup
    cfg = jcfg.TrainConfig(**TRAIN_CFG)
    jst = jstate.TrainState.create(
        apply_fn=jmodel.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.adam(jstate.lr_schedule(cfg, 100)))
    mesh = make_mesh(1, devices=jax.devices()[:1])
    scan = jstate.make_sharded_scan_step(mesh, batch_fn, N_INNER)
    jst, jlosses = scan(replicate(jst, mesh), ekey, jnp.int32(0))

    st = _port_state(variables)
    losses = tstate.make_scan_step(st, _feed(batches), N_INNER)(None)
    assert losses.shape == (N_INNER,) and st.step == N_INNER
    np.testing.assert_allclose(losses[0].numpy(), np.asarray(jlosses)[0],
                               rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    want = from_jax_variables(jax.tree.map(
        np.asarray, {'params': jst.params, 'batch_stats': jst.batch_stats}))
    sd = st.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                   atol=2 * N_INNER * LR, rtol=1e-5,
                                   err_msg=k)


def test_scan_equals_the_per_step_loop(scan_setup):
    _, variables, _, _, batches = scan_setup
    a, b = _port_state(variables), _port_state(variables)
    want = torch.stack([
        tstate.train_step(a, {k: torch.from_numpy(v) for k, v in x.items()})[
            'loss'] for x in batches])
    got = tstate.make_scan_step(b, _feed(batches), N_INNER)(None)
    assert torch.equal(want, got) and a.step == b.step == N_INNER
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match='n_inner'):
        tstate.make_scan_step(b, _feed(batches), 0)


def test_checkpoint_stores_the_plain_optimizer(tmp_path):
    """make_scan_step turns Adam's rate into a device tensor and
    ``capturable`` on; a checkpoint stores the float rate with
    ``capturable`` off, so it loads and steps on the CPU."""
    model = HRNet(tcfg.hrnet_tiny())
    st = tstate.create_train_state(model, tcfg.TrainConfig(**TRAIN_CFG), 100)
    batch = {'image': torch.randn(2, 32, 32, 1),
             'heatmaps': torch.rand(2, 32, 32, 6),
             'weights': torch.ones(2, 32, 32, 6)}
    tstate.train_step(st, batch)
    for group in st.optimizer.param_groups:
        group['lr'] = torch.tensor(LR)
        group['capturable'] = True
    mgr = tckpt.CheckpointManager(str(tmp_path / 'ck'))
    mgr.save('last', st, 0)
    assert isinstance(st.optimizer.param_groups[0]['lr'], torch.Tensor)
    fresh = tstate.create_train_state(HRNet(tcfg.hrnet_tiny()),
                                      tcfg.TrainConfig(**TRAIN_CFG), 100)
    fresh, epoch = mgr.restore('last', fresh)
    group = fresh.optimizer.param_groups[0]
    assert epoch == 1 and fresh.step == 1
    assert isinstance(group['lr'], float) and group['capturable'] is False
    assert group['lr'] == float(torch.tensor(LR))    # the f32 rate
    assert np.isfinite(float(tstate.train_step(fresh, batch)['loss']))


# --- the four public functions -----------------------------------------------

def test_quat_to_dcm_matches_jax():
    q = np.random.default_rng(0).normal(size=(8, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jcamera.quat_to_dcm(jnp.asarray(q)))
    got = tcamera.quat_to_dcm(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(got, tcamera.quat_to_rotmat(
        torch.from_numpy(q)).transpose(-1, -2))


def _angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _check_pose(R, t, jR, jt, R_gt, t_gt, t_bound, ang_bound):
    R, t = R.numpy().astype(np.float64), t.numpy().astype(np.float64)
    jR, jt = np.asarray(jR, np.float64), np.asarray(jt, np.float64)
    assert _angle(R, jR) <= 1e-3
    assert np.linalg.norm(t - jt) <= 1e-3 * np.linalg.norm(jt)
    assert np.linalg.norm(t - t_gt) < t_bound
    assert np.degrees(_angle(R, R_gt.astype(np.float64))) < ang_bound


@pytest.mark.parametrize('case', ['exact', 'noisy', 'masked'])
def test_epnp_single_matches_jax(case):
    seed, noise = {'exact': (1, 0.0), 'noisy': (2, 1.0),
                   'masked': (3, 0.0)}[case]
    p3, p2, R_gt, t_gt = _problem(seed=seed, noise_px=noise)
    w = None
    if case == 'masked':
        p2 = p2.copy()
        p2[:5] += 300.0                      # gross outliers, weighted out
        w = np.ones(30, np.float32)
        w[:5] = 0.0
    jR, jt = jepnp.epnp_single(jnp.asarray(p3), jnp.asarray(p2),
                               jnp.asarray(SPEED_K),
                               None if w is None else jnp.asarray(w))
    R, t = tepnp.epnp_single(T(p3), T(p2), T(SPEED_K),
                             None if w is None else T(w))
    assert R.shape == (3, 3) and t.shape == (3,)
    bounds = (0.1, 1.5) if case == 'noisy' else (5e-3, 0.1)
    _check_pose(R, t, jR, jt, R_gt, t_gt, *bounds)


def test_epnp_batched_matches_jax_and_single():
    probs = [_problem(seed=s) for s in range(4)]
    p3 = np.stack([p[0] for p in probs])
    p2 = np.stack([p[1] for p in probs])
    jR, jt = jepnp.epnp(jnp.asarray(p3), jnp.asarray(p2),
                        jnp.asarray(SPEED_K))
    R, t = tepnp.epnp(T(p3), T(p2), T(SPEED_K))
    assert R.shape == (4, 3, 3) and t.shape == (4, 3)
    for i, (_, _, R_gt, t_gt) in enumerate(probs):
        _check_pose(R[i], t[i], jR[i], jt[i], R_gt, t_gt, 5e-3, 0.1)
        Rs, _ = tepnp.epnp_single(T(p3[i]), T(p2[i]), T(SPEED_K))
        np.testing.assert_allclose(R[i].numpy(), Rs.numpy(), atol=2e-3)


def test_crop_resize_single_matches_jax():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, size=(60, 80)).astype(np.float32)
    origin = np.array([7, 5], np.int32)
    crop_sizes = np.array([40, 33], np.int32)
    size = np.array(40, np.int32)
    want = np.asarray(jcrop.crop_resize_single(
        jnp.asarray(image), jnp.asarray(origin), jnp.asarray(crop_sizes),
        jnp.asarray(size), 24))
    got = tcrop.crop_resize_single(T(image), T(origin), T(crop_sizes),
                                   T(size), 24)
    assert got.shape == (24, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
