"""The ResNet-8s family of the port (``models/resnet8s.py``) against the
JAX package's, with the JAX weights carried across by
``utils/artifact.from_jax_variables``, at depth 18 and narrow decoder
widths on 32x32 inputs.

Tolerances:
- forward in eval and train mode, and the running statistics after the
  train-mode forward: atol 1e-5 (rtol 1e-5 for the statistics);
- ``pvnet_loss`` and the weighted heatmap loss on the network's output:
  rtol 1e-5;
- one Adam step per mode from the same weights on the same batch
  (``cli/train_linemod.linemod_loss`` against the JAX driver's loss): loss
  rtol 1e-5, each gradient within 1e-4 of its tensor's norm, the
  parameters within 2 lr (Adam's first step moves an element by about
  +-lr, and a gradient near zero that the two packages sum to opposite
  signs moves the copies 2 lr apart), the running statistics rtol 1e-5;
- ``to_jax_variables`` gives back the JAX tree: the same paths, equal
  leaves.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.models import resnet8s as jr8
from esa_pose_estimation_tpu.ops import heatmap as jhm
from esa_pose_estimation_tpu.ops import vertex as jvert
from esa_pose_estimation_tpu.train.loss import weighted_heatmap_loss
from esa_pose_estimation_tpu_torch.cli import train_linemod as ttl
from esa_pose_estimation_tpu_torch.models import resnet8s as tr8
from esa_pose_estimation_tpu_torch.utils.artifact import (
    _flatten,
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


S, K, B, LR = 32, 5, 2, 1e-3
NARROW = dict(depth=18, fc_dim=16, s8_dim=16, s4_dim=8, s2_dim=8, raw_dim=8)


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    return np.asarray(a)


def _pair(mode):
    """(JAX module, its variables, the port's module with them)."""
    if mode == 'heatmap':
        jm = jr8.ResNet8s(ver_dim=K, **NARROW)
        tm = tr8.ResNet8s(ver_dim=K, **NARROW)
    else:
        jm = jr8.ResNet8s2o(ver_dim=2 * K, seg_dim=2, **NARROW)
        tm = tr8.ResNet8s2o(ver_dim=2 * K, seg_dim=2, **NARROW)
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, S, S, 3)),
                                          train=False))(
        jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # non-trivial running statistics, so eval mode tests them
    rng = np.random.default_rng(4)
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.0, 0.2, a.shape)).astype(np.float32),
        variables['batch_stats'])
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, tm


@pytest.fixture(scope='module', params=['heatmap', 'pvnet'])
def pair(request):
    return (request.param,) + _pair(request.param)


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    mask = np.zeros((B, S, S), np.float32)
    mask[:, 6:26, 8:24] = 1.0
    kp = rng.uniform(4, S - 4, (B, K, 2)).astype(np.float32)
    return img, mask, kp


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def test_forward_eval_and_train(pair):
    mode, jm, variables, tm = pair
    img, _, _ = _batch()
    want = _outs(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, img))
    tm.eval()
    with torch.no_grad():
        got = _outs(tm(T(img)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), N(w), atol=1e-5)
    out, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                             mutable=['batch_stats']))(
        variables, img)
    tm.train()
    with torch.no_grad():
        got = _outs(tm(T(img)))
    for g, w in zip(got, _outs(out)):
        np.testing.assert_allclose(g.numpy(), N(w), atol=1e-5)
    stats = from_jax_variables({'batch_stats': jax.tree_util.tree_map(
        np.asarray, mut['batch_stats'])})
    sd = tm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    tm.load_state_dict(from_jax_variables(variables))     # undo the update


def _jax_loss(mode, jm, variables, img, mask, kp):
    """The JAX driver's loss (cli/train_linemod.py step.loss_fn)."""
    def loss_fn(p):
        out, mut = jm.apply({'params': p,
                             'batch_stats': variables['batch_stats']},
                            img, train=True, mutable=['batch_stats'])
        if mode == 'heatmap':
            hm, wm = jhm.render_targets(kp, S, S, 2.0)
            loss = weighted_heatmap_loss(out, jnp.transpose(hm, (0, 2, 3, 1)),
                                         jnp.transpose(wm, (0, 2, 3, 1)))
        else:
            seg, vert = out
            loss = jr8.pvnet_loss(seg, vert, mask,
                                  jvert.vertex_field(mask, kp))
        return loss, mut
    return loss_fn


def test_losses_on_network_output(pair):
    mode, jm, variables, tm = pair
    img, mask, kp = _batch(6)
    want, _ = jax.jit(lambda p: _jax_loss(mode, jm, variables, img, mask,
                                          kp)(p))(variables['params'])
    tm.train()
    with torch.no_grad():
        got = ttl.linemod_loss(tm, T(img), mode, T(kp), T(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    tm.load_state_dict(from_jax_variables(variables))
    if mode == 'pvnet':
        rng = np.random.default_rng(7)
        seg = rng.normal(size=(B, S, S, 2)).astype(np.float32)
        vert = rng.normal(size=(B, S, S, 2 * K)).astype(np.float32)
        tgt = N(jvert.vertex_field(jnp.asarray(mask), jnp.asarray(kp)))
        np.testing.assert_allclose(
            float(tr8.pvnet_loss(T(seg), T(vert), T(mask), T(tgt))),
            float(jr8.pvnet_loss(jnp.asarray(seg), jnp.asarray(vert),
                                 jnp.asarray(mask), jnp.asarray(tgt))),
            rtol=1e-5)


def test_one_adam_step(pair):
    mode, jm, variables, tm = pair
    img, mask, kp = _batch(8)
    tx = optax.adam(optax.cosine_decay_schedule(LR, 10, 0.01))

    @jax.jit
    def step(params, opt_state):
        (loss, mut), grads = jax.value_and_grad(
            _jax_loss(mode, jm, variables, img, mask, kp),
            has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return (optax.apply_updates(params, updates), mut['batch_stats'],
                loss, grads)

    params, stats, loss, grads = step(variables['params'],
                                      tx.init(variables['params']))
    st = ttl.create_state(tm, LR, 10)
    res = {}

    def loss_fn(m):
        out = ttl.linemod_loss(m, T(img), mode, T(kp), T(mask))
        res['loss'] = out
        return out
    import esa_pose_estimation_tpu_torch.train.state as state_mod
    # the gradients are read inside the step, before Adam applies them
    got_grads = {}
    orig = st.optimizer.step

    def spy(*a, **k):
        got_grads.update({n: p.grad.clone()
                          for n, p in tm.named_parameters()})
        return orig(*a, **k)
    st.optimizer.step = spy
    state_mod.optimize(st, loss_fn)
    np.testing.assert_allclose(float(res['loss']), float(loss), rtol=1e-5)
    want_g = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, grads)})
    for k, g in want_g.items():
        scale = float(g.norm()) + 1e-12
        assert float((got_grads[k] - g).abs().max()) <= 1e-4 * scale, k
    want_p = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, params), 'batch_stats': jax.tree_util.tree_map(
        np.asarray, stats)})
    sd = tm.state_dict()
    for k, v in want_p.items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            assert float((sd[k] - v).abs().max()) <= 2 * LR, k
    tm.load_state_dict(from_jax_variables(variables))     # undo the step


def test_to_jax_variables_round_trip(pair):
    _, _, variables, tm = pair
    back = to_jax_variables(tm)
    for col in ('params', 'batch_stats'):
        want = _flatten(variables[col])
        got = _flatten(back[col])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('tap', ['fc', '8s'])
def test_detector_head_and_bottleneck_backbone(tap):
    """ResNet8sDetector at depth 18, and the depth-50 backbone's
    bottleneck blocks through a ResNet8s at narrow decoder widths."""
    img = np.random.default_rng(9).normal(size=(1, S, S, 3)).astype(
        np.float32)
    cases = [(jr8.ResNet8sDetector(depth=18, tap=tap),
              tr8.ResNet8sDetector(depth=18, tap=tap))]
    if tap == 'fc':
        kw = dict(NARROW, depth=50)
        cases.append((jr8.ResNet8s(ver_dim=3, **kw),
                      tr8.ResNet8s(ver_dim=3, **kw)))
    for jm, tm in cases:
        v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, S, S, 3))))(
            jax.random.PRNGKey(1))
        v = jax.tree_util.tree_map(np.asarray, dict(v))
        tm.load_state_dict(from_jax_variables(v), strict=True)
        want = jax.jit(lambda vv, x: jm.apply(vv, x))(v, img)
        with torch.no_grad():
            got = tm.eval()(T(img))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), N(want), atol=1e-5)


def test_builders_and_init():
    m = tr8.resnet18_8s(ver_dim=9)
    assert m.Conv_0.out_channels == 9
    assert tr8.resnet34_8s().ResNetBackbone8s_0.n_blocks == 16
    assert tr8.resnet50_8s().ResNetBackbone8s_0.block_name == 'ResBottleneck'
    m.init_weights(torch.Generator().manual_seed(0))
    bn = m.ResNetBackbone8s_0.BatchNorm_0
    assert bool((bn.weight == 1).all()) and bool((bn.bias == 0).all())
    assert float(m.Conv_0.bias.abs().sum()) == 0.0
    w = m.ResNetBackbone8s_0.Conv_0.weight
    std = (1.0 / w[0].numel()) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
