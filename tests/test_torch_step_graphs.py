"""The compiled training programs of the port (``train/state.make_train_steps``
and the routes built on it: the shard and pickle steps of ``cli/train``,
the detector step, LINEMOD's rendered epoch and real step), the
deterministic backward of the half-pixel resize, and the storage check of
every captured graph, on the CPU.  The graphs themselves run on the card
only (``chip_smoke.py`` phase 21); on the CPU every entry point runs the
same steps eagerly.

Tolerances:
- the resize's backward against autograd through ``F.interpolate`` (both
  f32, a product against a sum of two taps per output): 2e-6 of the
  largest gradient entry (measured 8e-7); its forward ``torch.equal``;
  against ``jax.grad`` of ``jax.image.resize``: 1e-5 of the largest entry,
  the port's f32 parity tolerance;
- each route's program against the per-step loop it replaces, on the
  same draws: ``torch.equal`` in losses, parameters and statistics (the
  same operations);
- the detector step and the shard route's step against JAX's jitted
  steps (``make_train_step``; ``make_sharded_train_step`` on a
  one-device mesh), fed JAX's batches and draws: the loss 1e-5 relative;
  each parameter's gradient (JAX's read from Adam's first moment,
  ``mu = (1 - b1) g`` after one step) within 1e-4 of its norm for the
  detector, as test_torch_train holds a step's, and 1e-2 for the shard
  step, whose batch build (rotation, photometric perturbation) enters at
  its own imagery tolerance (test_torch_train_data; measured 4.1e-3 of
  the norm, on BatchNorm biases, whose gradients cancel); each
  parameter's change in the step at a cosine of at least 0.99 to JAX's
  (a missing or reversed update is 0 or -1; measured 0.998 at least);
  parameters within 2 lr (ROADMAP.md section 3: Adam's m/sqrt(v)
  saturates near zero gradients), running statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu.cli import train_detector as jtd
from esa_pose_estimation_tpu.data import pipeline as jpipe
from esa_pose_estimation_tpu.models import detector as jdet
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.parallel.mesh import make_mesh, replicate
from esa_pose_estimation_tpu.train import state as jstate
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch.cli import train_detector as ttd
from esa_pose_estimation_tpu_torch.cli import train_linemod as tlm
from esa_pose_estimation_tpu_torch.data import pipeline as tpipe
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.models import layers
from esa_pose_estimation_tpu_torch.models.detector import TinyDetector
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils import graphs
from esa_pose_estimation_tpu_torch.utils.artifact import (
    from_jax_variables,
    load_detector,
)
from tests.test_torch_detector_train import _jax_frames
from tests.test_torch_train_data import (
    _crops,
    _jax_build_draws,
    _jax_perturb_draws,
)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _states_equal(a, b) -> None:
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k


# --- the half-pixel resize's backward ----------------------------------------

RESIZES = [((2, 3, 8, 8), (16, 16)), ((1, 4, 4, 8), (32, 64)),
           ((2, 2, 16, 16), (128, 128)), ((1, 3, 3, 5), (12, 20))]


@pytest.mark.parametrize('shape,out', RESIZES)
@pytest.mark.parametrize('channels_last', [False, True])
def test_resize_backward_equals_interpolate_autograd(shape, out,
                                                     channels_last):
    rng = np.random.default_rng(shape[-1])
    x = T(rng.normal(size=shape).astype(np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    go = T(rng.normal(size=shape[:2] + out).astype(np.float32))
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya = layers.resize_bilinear(a, out)
    yb = F.interpolate(b, size=out, mode='bilinear', align_corners=False)
    assert torch.equal(ya, yb)
    ya.backward(go)
    yb.backward(go)
    scale = float(b.grad.abs().max())
    assert float((a.grad - b.grad).abs().max()) <= 2e-6 * scale


@pytest.mark.parametrize('shape,out', RESIZES[:3])
def test_resize_backward_matches_jax_grad(shape, out):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    go = rng.normal(size=shape[:2] + out).astype(np.float32)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jax.image.resize(
        v, shape[:2] + out, 'bilinear') * go)))(jnp.asarray(x))
    a = T(x).requires_grad_(True)
    layers.resize_bilinear(a, out).backward(T(go))
    want = np.asarray(want)
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# --- cuDNN's deterministic algorithms in training ----------------------------

def _tiny_batch():
    return {'image': torch.randn(2, 32, 32, 1, generator=gen(1)),
            'heatmaps': torch.rand(2, 32, 32, 6, generator=gen(2)),
            'weights': torch.ones(2, 32, 32, 6)}


@pytest.mark.parametrize('before', [False, True])
def test_training_steps_run_with_deterministic_cudnn(before):
    """The training path turns ``torch.backends.cudnn.deterministic`` on
    for each step's forward and backward, and gives the process its own
    setting back after it; making a train state leaves it alone."""
    prev = torch.backends.cudnn.deterministic
    seen = []

    def loss_fn(model, batch):
        seen.append(('forward', torch.backends.cudnn.deterministic))
        loss = tstate.heatmap_step_loss(model, batch)
        loss.register_hook(lambda g: seen.append(
            ('backward', torch.backends.cudnn.deterministic)))
        return loss
    try:
        torch.backends.cudnn.deterministic = before
        st = _tiny_state()
        assert torch.backends.cudnn.deterministic == before
        tstate.make_train_steps(st, loss_fn, 2)([_tiny_batch()] * 2)
        assert seen == [('forward', True), ('backward', True)] * 2
        assert torch.backends.cudnn.deterministic == before
        with tstate.deterministic_cudnn():
            assert torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.deterministic == before
    finally:
        torch.backends.cudnn.deterministic = prev


# --- a graph's storage check -------------------------------------------------

def test_check_pointers_is_a_comparison():
    graphs.check_pointers((1, 2, 3), (1, 2, 3))
    graphs.check_pointers((), ())
    with pytest.raises(RuntimeError, match=r'positions \[1\]'):
        graphs.check_pointers((1, 2, 3), (1, 5, 3))
    with pytest.raises(RuntimeError, match='replaced'):
        graphs.check_pointers((1, 2, 3), (1, 2))
    assert graphs.storage_pointers([None, torch.zeros(1)])[0] == 0


@pytest.mark.parametrize('replace', ['assign', 'compute_dtype', 'grads'])
def test_storage_pointers_see_replaced_tensors(replace):
    """Writes in place (a copy, an optimizer step) keep every pointer; a
    ``load_state_dict(..., assign=True)``, the serving form's cast or a
    gradient dropped and made anew replace storage, which the check
    raises on."""
    model = HRNet(tcfg.hrnet_tiny(), dtype=torch.bfloat16)
    st = tstate.create_train_state(model, tcfg.TrainConfig(), 100)
    batch = {'image': torch.randn(2, 32, 32, 1),
             'heatmaps': torch.rand(2, 32, 32, 6),
             'weights': torch.ones(2, 32, 32, 6)}
    tstate.train_step(st, batch)

    read = graphs.tensor_reader([model], grads=True)

    def pointers():
        return graphs.storage_pointers(read())
    before = pointers()
    assert 0 not in before
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p * 0.5)
    model.zero_grad(set_to_none=False)
    st.optimizer.step()
    graphs.check_pointers(before, pointers())
    if replace == 'assign':
        model.load_state_dict({k: v.clone() for k, v in
                               model.state_dict().items()}, assign=True)
    elif replace == 'compute_dtype':
        layers.store_in_compute_dtype(model)
    else:
        tstate.train_step(st, batch)      # set_to_none, then new gradients
    with pytest.raises(RuntimeError, match='replaced'):
        graphs.check_pointers(before, pointers())
    serving = graphs.tensor_reader([model])()
    assert len(serving) == len(before) - len(list(model.parameters()))
    assert [id(t) for t in serving] == [id(t) for t in list(
        model.parameters()) + list(model.buffers())]


# --- each route's program against the per-step loop it replaces -------------

def _tiny_state(seed=0):
    model = HRNet(tcfg.hrnet_tiny())
    model.init_weights(gen(seed))
    return tstate.create_train_state(model, tcfg.TrainConfig(), 10)


def _shard_batches(kind):
    """Two loader batches of 3: host crops (crop, rate, origin) or
    1920x1200 frames (frame, bbox), with keypoints and a 'name' list."""
    rng = np.random.default_rng(3)
    out = []
    for j in range(2):
        kp = rng.uniform(200, 1500, (3, 6, 2)).astype(np.float32)
        if kind == 'crop':
            b = {'crop': T(_crops(j, b=3)),
                 'rate': T(np.full(3, 0.1, np.float32)),
                 'origin': T(np.full((3, 2), 150, np.int32))}
        else:
            frames, boxes, _, _ = _jax_frames(j, 3, 1200, 1920)
            b = {'frame': T(frames), 'bbox': T(boxes)}
        out.append({**b, 'keypoints_2d': T(kp), 'name': ['a', 'b', 'c']})
    return out


def _shard_route(kind, a, b):
    crop, norm = 32, 0.5
    want = torch.stack([tstate.train_step(a, tpipe.build_shard_batch(
        x, ga, crop_size=crop, norm_mean=norm, augment_geom=True,
        augment_photo=True))['loss'] for x, ga in
        zip(_shard_batches(kind), [gen(5)] * 2)])
    g = gen(5)
    step = tstate.make_train_steps(b, lambda m, x: tpipe.step_loss(
        m, x, crop, norm, True, True))
    got = torch.cat([step([tpipe.step_inputs(x, g, crop, True, True)])
                     for x in _shard_batches(kind)])
    return want, got


def _detector_route(perturb, a, b):
    pts = tsyn.spacecraft_points()

    def frames(i):
        return ttd.make_frame_batch(gen(10 + i), 2, pts, 96, 160)
    want = []
    for i in range(2):
        f, bx = frames(i)
        if perturb:
            f = ttd.perturb_frames(gen(20 + i), f)
        want.append(ttd.train_step(a, f, bx, 16, 4)['loss'])
    step = tstate.make_train_steps(b, lambda m, x: ttd.step_loss(m, x, 16,
                                                                 4))
    got = torch.cat([step([ttd.step_inputs(*frames(i), gen(20 + i)
                                           if perturb else None)])
                     for i in range(2)])
    return torch.stack(want), got


def _linemod_setup():
    verts, faces = tlm.make_icosphere()
    vt, ft = T(verts), T(faces)
    return vt, ft, vt[::13][:5].contiguous()


def _linemod_scan(mode, a, b):
    vt, ft, kp3d = _linemod_setup()
    want = []
    for j in range(2):
        batch = tlm.synthetic_linemod_batch(gen(30 + j), 2, vt, ft, kp3d, 32)
        img = tlm.synthetic_inputs(batch)
        want.append(tstate.optimize(a, lambda m: tlm.linemod_loss(
            m, img, mode, batch['keypoints_2d'], batch['mask']))['loss'])
    scan = tstate.make_train_steps(b, lambda m, d: tlm.synthetic_step_loss(
        m, d, mode, vt, ft, kp3d, 32), 2)
    got = scan([tlm.draw_synthetic_poses(gen(30 + j), 2) for j in range(2)])
    return torch.stack(want), got


def _real_batches():
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        yy, xx = np.mgrid[:96, :128]
        mask = ((xx - 64) ** 2 + (yy - 48) ** 2 < 400).astype(np.float32)
        out.append({
            'frame': rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32),
            'bbox': np.array([[40, 25, 88, 72]] * 2, np.float32),
            'keypoints_2d': rng.uniform(45, 80, (2, 5, 2)).astype(np.float32),
            'mask': np.stack([mask] * 2)})
    return out


def _linemod_real(mode, a, b):
    want = []
    for j, x in enumerate(_real_batches()):
        img, mcrop, kp = tlm.real_batch(
            T(x['frame']), T(x['bbox']), T(x['keypoints_2d']), T(x['mask']),
            32, True, gen(40 + j))
        want.append(tstate.optimize(a, lambda m: tlm.linemod_loss(
            m, img, mode, kp, mcrop))['loss'])
    step = tstate.make_train_steps(b, lambda m, x: tlm.real_step_loss(
        m, x, mode, 32))
    got = torch.cat([step([tlm.real_step_inputs(x, 32, True, gen(40 + j),
                                                'cpu')])
                     for j, x in enumerate(_real_batches())])
    return torch.stack(want), got


def _lm_state(mode):
    model = tlm.build_model(mode, 5)
    model.init_weights(gen(0))
    return tlm.create_state(model, 1e-3, 10)


def _det_state():
    model = TinyDetector(width=8, stride=16)
    model.init_weights(gen(0))
    return ttd.create_detector_state(model, 1e-3, 10)


ROUTES = {
    'shard_host_crop': (lambda: _tiny_state(),
                        lambda a, b: _shard_route('crop', a, b)),
    'shard_and_pickle_frames': (lambda: _tiny_state(),
                                lambda a, b: _shard_route('frame', a, b)),
    'detector': (_det_state, lambda a, b: _detector_route(False, a, b)),
    'detector_perturbed': (_det_state,
                           lambda a, b: _detector_route(True, a, b)),
    'linemod_scan_heatmap': (lambda: _lm_state('heatmap'),
                             lambda a, b: _linemod_scan('heatmap', a, b)),
    'linemod_scan_pvnet': (lambda: _lm_state('pvnet'),
                           lambda a, b: _linemod_scan('pvnet', a, b)),
    'linemod_real_heatmap': (lambda: _lm_state('heatmap'),
                             lambda a, b: _linemod_real('heatmap', a, b)),
    'linemod_real_pvnet': (lambda: _lm_state('pvnet'),
                           lambda a, b: _linemod_real('pvnet', a, b)),
}


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_program_equals_the_per_step_loop(route):
    make_state, run = ROUTES[route]
    a, b = make_state(), make_state()
    want, got = run(a, b)
    assert got.shape == (2,) and torch.isfinite(got).all()
    assert torch.equal(want, got) and a.step == b.step == 2
    _states_equal(a, b)


def test_make_train_steps_checks_its_inputs():
    st = _tiny_state()
    with pytest.raises(ValueError, match='n_inner'):
        tstate.make_train_steps(st, tstate.heatmap_step_loss, 0)
    cpu = tstate.make_train_steps(st, tstate.heatmap_step_loss)
    assert not isinstance(cpu, tstate.StepGraph)


@pytest.mark.parametrize('steps', [1, tstate.DDP_WARM_UP_STEPS])
@pytest.mark.parametrize('trained', [False, True])
def test_warm_up_puts_the_state_back(steps, trained, one_thread):
    """The eager steps before a capture (``_warm_up_restored``, k of them:
    1, or 11 under DistributedDataParallel) leave the parameters, the
    statistics, Adam's state and the step count bit for bit as they were,
    so the next step is the one of a state that never warmed up, with
    Adam's state made by the warm-up (zero) or there before it."""
    a, b = _tiny_state(), _tiny_state()
    batch = _tiny_batch()
    if trained:
        for st in (a, b):
            tstate.train_step(st, batch)
    before = [t.clone() for t in tstate.state_tensors(a)]
    tstate._warm_up_restored(
        a, lambda: tstate.optimize(a, lambda m: tstate.heatmap_step_loss(
            m, batch)), torch.device('cpu'), steps)
    now = tstate.state_tensors(a)
    assert len(now) == len(before) + (0 if trained else 3 * len(
        list(a.model.parameters())))
    assert all(torch.equal(x, y) for x, y in zip(now, before))
    assert a.step == b.step == int(trained)
    assert tstate.warm_up_steps(a) == 1
    assert torch.equal(tstate.train_step(a, batch)['loss'],
                       tstate.train_step(b, batch)['loss'])
    _states_equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(tstate.state_tensors(a),
                                                 tstate.state_tensors(b)))


# --- against JAX's jitted steps ----------------------------------------------

def _assert_params_close(port_sd, jax_state, n_steps):
    want = from_jax_variables(jax.tree.map(np.asarray, {
        'params': jax_state.params, 'batch_stats': jax_state.batch_stats}))
    assert set(port_sd) == set(want)
    for k, v in want.items():
        tol = 1e-5 if 'running' in k else 2 * LR * n_steps
        np.testing.assert_allclose(port_sd[k].numpy(), v.numpy(), atol=tol,
                                   rtol=1e-5, err_msg=k)


def _assert_update_close(model, start, jax_state, grad_tol):
    """One step's gradients and parameter changes against JAX's, leaf by
    leaf: the gradients read from Adam's first moment (optax's
    ``mu = (1 - b1) g``, b1 = 0.9) within ``grad_tol`` of their norm, the
    changes from ``start`` at a cosine of at least 0.99."""
    grads = from_jax_variables({'params': jax.tree.map(
        lambda m: np.asarray(m) / np.float32(0.1),
        jax_state.opt_state[0].mu)})
    params = from_jax_variables({'params': jax.tree.map(
        np.asarray, jax_state.params)})
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for n, g in grads.items():
        norm = float(np.linalg.norm(g.numpy()))
        diff = float((named[n].grad - g).abs().max())
        assert diff <= grad_tol * norm + 1e-12, (n, diff, norm)
        got = (named[n].detach() - start[n]).flatten().double()
        want = (params[n] - start[n]).flatten().double()
        cos = float(got @ want) / max(float(got.norm() * want.norm()),
                                      1e-30)
        assert cos >= 0.99, (n, cos)


def _start(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_detector_step_matches_jax():
    """The detector's program (perturbation, pooling, targets, step) on
    JAX's frames and perturbation draws, against JAX's jitted
    ``perturb_frames`` and ``make_train_step``."""
    h, w, ds = 96, 160, 4
    model = jdet.TinyDetector(width=8, stride=16)
    js = jtd.create_detector_state(model, jax.random.PRNGKey(0), LR,
                                   (h // ds, w // ds), total_steps=10)
    variables = jax.tree.map(np.asarray, {'params': js.params,
                                          'batch_stats': js.batch_stats})
    frames, boxes, _, _ = _jax_frames(1, 4, h, w)
    key = jax.random.PRNGKey(11)
    perturbed = jax.jit(jtd.perturb_frames)(key, jnp.asarray(frames))
    js2, jloss = jtd.make_train_step(model, 16, ds)(js, perturbed,
                                                    jnp.asarray(boxes))
    st = ttd.create_detector_state(load_detector(variables, width=8,
                                                 device='cpu'), LR, 10)
    step = tstate.make_train_steps(st, lambda m, x: ttd.step_loss(m, x, 16,
                                                                  ds))
    start = _start(st.model)
    loss = step([{'frames': T(frames), 'bboxes': T(boxes),
                  'perturb': _jax_perturb_draws(key, 4, h, w)}])
    assert float(loss[0]) == pytest.approx(float(jloss), rel=1e-5)
    _assert_update_close(st.model, start, js2, 1e-4)
    _assert_params_close(st.model.state_dict(), js2, 1)


def test_shard_step_matches_jax_sharded_step():
    """The shard route's program with host crops (``build_shard_batch`` and
    the step), on JAX's draws, against JAX's jitted
    ``build_batch_from_crops`` and ``make_sharded_train_step`` on a
    one-device mesh, ``hrnet_tiny`` in f32."""
    jmodel = JaxHRNet(jcfg.hrnet_tiny())
    variables = jax.tree.map(np.array, jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 32, 32, 1)), train=False))(jax.random.PRNGKey(2)))
    cfg = dict(batch_size=4, crop_size=32, lr=LR, lr_values=(LR, LR, LR, LR),
               lr_boundaries=(100, 200, 300))
    js = jstate.TrainState.create(
        apply_fn=jmodel.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.adam(jstate.lr_schedule(
            jcfg.TrainConfig(**cfg), 100)))
    x = _crops(9, b=4)
    rates = np.full(4, 0.1, np.float32)
    origins = np.array([[100, 40], [8, 900], [1500, 20], [0, 0]], np.int32)
    kp = (origins[:, None, :] + np.random.default_rng(2).uniform(
        2, 30, (4, 6, 2)) / rates[:, None, None]).astype(np.float32)
    key = jax.random.PRNGKey(43)
    batch = jax.jit(lambda k: jpipe.build_batch_from_crops(
        jnp.asarray(x), jnp.asarray(rates), jnp.asarray(origins),
        jnp.asarray(kp), k, augment_geom=True, augment_photo=True))(key)
    mesh = make_mesh(1, devices=jax.devices()[:1])
    js2, jmetrics = jstate.make_sharded_train_step(mesh)(
        replicate(js, mesh), {k: batch[k] for k in
                              ('image', 'heatmaps', 'weights')})
    model = HRNet(tcfg.hrnet_tiny())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    st = tstate.create_train_state(model, tcfg.TrainConfig(**cfg), 100)
    step = tstate.make_train_steps(st, lambda m, x: tpipe.step_loss(
        m, x, 32, 0.449, True, True))
    start = _start(st.model)
    loss = step([{'batch': {'crop': T(x), 'rate': T(rates),
                            'origin': T(origins), 'keypoints_2d': T(kp)},
                  'draws': _jax_build_draws(key, 4, 32, True, True)}])
    assert float(loss[0]) == pytest.approx(float(jmetrics['loss']),
                                           rel=1e-5)
    _assert_update_close(st.model, start, js2, 1e-2)
    _assert_params_close(st.model.state_dict(), js2, 1)
