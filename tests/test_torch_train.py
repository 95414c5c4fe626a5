"""Keypoint training in the port against the JAX package: targets, losses,
the learning-rate schedule, the train-mode BatchNorm, one Adam step, and
the f32 master weights under the bf16 serving forward.

Everything runs in f32 on ``hrnet_tiny`` at 32x32 crops, as the JAX
package's own train tests do (its bf16 programs take minutes to compile on
the CPU).  Tolerances:
- targets (heatmaps, weight maps) atol 1e-6;
- the seven losses rtol 1e-6 (atol 1e-6 near zero); the gradient of
  ``weighted_heatmap_loss`` atol 1e-5 relative to its largest element;
- learning rates rtol 1e-6 (optax computes in f32, the port in f64);
- a train-mode forward: heatmaps and every BatchNorm running statistic
  atol and rtol 1e-5 (running variances reach the hundreds);
- one train step from JAX-initialised weights: loss rtol 1e-5, each
  gradient leaf within 1e-4 of its norm, parameters within lr (Adam moves
  an element by at most lr a step, and for near-zero gradients m/sqrt(v)
  saturates at +-1, so a reassociated sum may move it that far), the
  losses of three steps rtol 1e-4;
- serving: the r5 weights as f32 masters and in the stored-bf16 serving
  form give ``torch.equal`` heatmaps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.ops import heatmap as jheat
from esa_pose_estimation_tpu.train import loss as jloss
from esa_pose_estimation_tpu.train import state as jstate
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch.models import layers
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.ops import heatmap as theat
from esa_pose_estimation_tpu_torch.train import loss as tloss
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils.artifact import (
    from_jax_variables,
    load_hrnet_artifact,
    read_artifact,
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
TRAIN_CFG = dict(batch_size=8, crop_size=32, lr=LR,
                 lr_values=(LR, 1e-4, 1e-5, 1e-6))


def test_targets_match_jax():
    rng = np.random.default_rng(0)
    # keypoints inside, on and past the border of a 40x32 map
    kp = rng.uniform(-3, 42, size=(3, 5, 2)).astype(np.float32)
    want = jheat.render_targets(jnp.asarray(kp), 32, 40, 2.0)
    got = theat.render_targets(torch.from_numpy(kp), 32, 40, 2.0)
    for g, w in zip(got, want):
        assert g.shape == (3, 5, 32, 40)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    for one in (False, True):
        np.testing.assert_allclose(
            theat.render_heatmaps(torch.from_numpy(kp), 8, 9, 1.5,
                                  one_indexed=one).numpy(),
            np.asarray(jheat.render_heatmaps(jnp.asarray(kp), 8, 9, 1.5,
                                             one_indexed=one)),
            atol=1e-6, rtol=0)
    hm = rng.uniform(0, 0.3, size=(2, 4, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        theat.weight_maps(torch.from_numpy(hm), 0.25).numpy(),
        np.asarray(jheat.weight_maps(jnp.asarray(hm), 0.25)))


def _loss_inputs(seed=1):
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, 1, size=(2, 8, 8, 3)).astype(np.float32)
    pred = np.clip(y + rng.normal(scale=0.4, size=y.shape), -0.6, 1.6
                   ).astype(np.float32)
    mask = rng.uniform(0, 1, size=y.shape).astype(np.float32)
    return pred, y, mask


@pytest.mark.parametrize('name', ['heatmap_wing', 'adaptive_wing', 'wing',
                                  'smooth_l1', 'wloss', 'focal_l2',
                                  'weighted_heatmap_loss'])
def test_losses_match_jax(name):
    pred, y, mask = _loss_inputs()
    args = (pred, y, mask) if name in ('focal_l2',
                                       'weighted_heatmap_loss') else (pred, y)
    want = np.asarray(getattr(jloss, name)(*map(jnp.asarray, args)))
    got = getattr(tloss, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_weighted_loss_gradient_matches_jax():
    pred, y, mask = _loss_inputs(2)
    want = np.asarray(jax.grad(jloss.weighted_heatmap_loss)(
        jnp.asarray(pred), jnp.asarray(y), jnp.asarray(mask)))
    p = torch.from_numpy(pred).requires_grad_(True)
    tloss.weighted_heatmap_loss(p, torch.from_numpy(y),
                                torch.from_numpy(mask)).backward()
    got = p.grad.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('bounds,values,spe', [
    ((80, 100, 170), (1e-4, 1e-5, 1e-6, 1e-7), 10),
    ((2, 2, 3), (1e-4, 1e-5, 1e-6, 1e-7), 7),      # a duplicate boundary
    ((1, 1, 1), (1e-3, 1e-4, 1e-5, 1e-6), 3),
])
def test_lr_schedule_matches_optax(bounds, values, spe):
    kw = dict(lr_boundaries=bounds, lr_values=values)
    want = jstate.lr_schedule(jcfg.TrainConfig(**kw), spe)
    got = tstate.lr_schedule(tcfg.TrainConfig(**kw), spe)
    steps = sorted({0, 10**6} | {b * spe + d for b in bounds
                                 for d in (-1, 0, 1)})
    for s in steps:
        assert got(s) == pytest.approx(float(want(s)), rel=1e-6), s
    bad = dict(lr_boundaries=(1, 2), lr_values=(1e-3, 1e-4))
    with pytest.raises(ValueError, match='lr_values'):
        tstate.lr_schedule(tcfg.TrainConfig(**bad), spe)


@pytest.fixture(scope='module')
def tiny():
    """hrnet_tiny's JAX initial variables and a batch of 8 (f32, numpy):
    JAX-made heatmap and weight targets, standard-normal images.

    Not the synthetic crops: on their flat background a channel's batch
    mean is tens of times its spread, and the fast variance
    mean(x^2) - mean(x)^2 then multiplies the summation error of the mean
    by mean^2/var.  JAX's f32 reductions on the CPU sum with a relative
    error near 2e-6 (the port's pairwise sums near 7e-8), so on those
    crops the JAX forward misses an f64 forward of the port by 2.0e-3 while
    the port's f32 forward stays within 3.3e-6 of it (measured on this
    fixture's weights and JAX batch).  On noise both sit close to f64 and
    can be held to each other."""
    model = JaxHRNet(jcfg.hrnet_tiny())
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 1)), train=False))(jax.random.PRNGKey(1))
    batch = jsyn.make_batch(jax.random.PRNGKey(0), 8,
                            jsyn.spacecraft_points(6), crop_size=32)
    batch = {k: np.array(batch[k]) for k in ('heatmaps', 'weights')}
    batch['image'] = np.random.default_rng(3).normal(
        size=(8, 32, 32, 1)).astype(np.float32)
    return model, jax.tree.map(np.array, variables), batch


def _port_model(variables):
    model = HRNet(tcfg.hrnet_tiny())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_forward_batch_stats_match_jax(tiny):
    """One train-mode forward: the output (batch statistics) and every
    running statistic, which checks each site's momentum (0.9 in block
    bodies, 0.99 elsewhere)."""
    jmodel, variables, batch = tiny
    out, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=['batch_stats']))(
        variables, jnp.asarray(batch['image']))
    model = _port_model(variables).train()
    got = model(torch.from_numpy(batch['image']))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    want = from_jax_variables({'batch_stats': jax.tree.map(
        np.asarray, mutated['batch_stats'])})
    sd = model.state_dict()
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
        moved += not np.array_equal(w.numpy(), from_jax_variables(
            {'batch_stats': variables['batch_stats']})[k].numpy())
    assert moved == len(want)            # every statistic was updated
    momenta = {m.momentum for m in model.modules()
               if isinstance(m, layers.BatchNorm)}
    assert momenta == {0.9, 0.99}


def test_train_step_matches_jax(tiny):
    jmodel, variables, batch = tiny
    cfg = jcfg.TrainConfig(**TRAIN_CFG)
    tx = optax.adam(jstate.lr_schedule(cfg, 100))

    @jax.jit
    def jax_step(params, stats, opt_state, b):
        def loss_fn(p):
            out, mut = jmodel.apply({'params': p, 'batch_stats': stats},
                                    b['image'], train=True,
                                    mutable=['batch_stats'])
            return jloss.weighted_heatmap_loss(out, b['heatmaps'],
                                               b['weights']), mut
        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (loss, grads, optax.apply_updates(params, updates),
                mut['batch_stats'], opt_state)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)
    model = _port_model(variables)
    st = tstate.create_train_state(model, tcfg.TrainConfig(**TRAIN_CFG), 100)
    tb = _torch_batch(batch)
    for step in range(3):
        loss, grads, params, stats, opt_state = jax_step(params, stats,
                                                         opt_state, jb)
        metrics = tstate.train_step(st, tb)
        rtol = 1e-5 if step == 0 else 1e-4
        assert float(metrics['loss']) == pytest.approx(float(loss),
                                                       rel=rtol), step
        if step == 0:
            tgrads = {n: p.grad for n, p in model.named_parameters()}
            jgrads = from_jax_variables({'params': jax.tree.map(np.asarray,
                                                                grads)})
            assert set(tgrads) == set(jgrads)
            for n, g in jgrads.items():
                norm = float(np.linalg.norm(g.numpy()))
                diff = float((tgrads[n] - g).abs().max())
                assert diff <= 1e-4 * norm + 1e-12, (n, diff, norm)
            assert float(metrics['grad_norm']) == pytest.approx(
                float(optax.global_norm(grads)), rel=1e-4)
            want = from_jax_variables(jax.tree.map(
                np.asarray, {'params': params, 'batch_stats': stats}))
            sd = model.state_dict()
            for k, w in want.items():
                tol = LR if 'running' not in k else 1e-5
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                           atol=tol, rtol=1e-5, err_msg=k)
    assert st.step == 3


def test_eval_step_uses_frozen_statistics(tiny):
    jmodel, variables, batch = tiny
    model = _port_model(variables)
    st = tstate.TrainState(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out, loss = tstate.eval_step(st, _torch_batch(batch))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(batch['image']))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert float(loss) == pytest.approx(float(jloss.weighted_heatmap_loss(
        want, jnp.asarray(batch['heatmaps']),
        jnp.asarray(batch['weights']))), rel=1e-5)
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())


def test_init_weights_matches_flax_statistics():
    """HRNet.init_weights draws Flax's initialisers: LeCun-normal kernels
    (std 1/sqrt(fan_in), truncated at 2 std), zero biases, identity BN;
    the statistics on a kernel of the flagship's 480 -> 480 head conv."""
    model = HRNet(tcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0))
    assert float(model.output_conv.bias.detach().abs().max()) == 0.0
    assert float(model.stem_bn1.weight.detach().min()) == 1.0
    assert float(model.stem_bn1.running_var.min()) == 1.0
    w = torch.empty((480, 480, 3, 3))
    layers.lecun_normal_(w, torch.Generator().manual_seed(0))
    fan_in = w[0].numel()
    assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.02)
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6


def test_serving_form_equals_f32_masters():
    """The r5 weights as f32 masters (cast at each use) and as the
    loader's stored-bf16 serving form give the same heatmaps, bit for
    bit; the masters hold f32 parameters."""
    variables, _ = read_artifact('artifacts/esa_syn_r5.npz')
    masters = HRNet(tcfg.hrnet_esa(), dtype=torch.bfloat16)
    masters.load_state_dict(from_jax_variables(variables), strict=True)
    masters = masters.to(memory_format=torch.channels_last).eval()
    assert masters.stem_conv1.weight.dtype == torch.float32
    # the flagship's parameter count, which sizes Adam's state
    assert sum(p.numel() for p in masters.parameters()) == 10_836_632
    serving = load_hrnet_artifact('artifacts/esa_syn_r5.npz', device='cpu')
    assert serving.stem_conv1.weight.dtype == torch.bfloat16
    x = torch.randn((2, 128, 128, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(masters(x), serving(x))


def _as_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize('name', ['hrnet_esa', 'hrnet_rgb32', 'hrnet_gray11',
                                  'hrnet_tiny', 'TrainConfig', 'LossConfig'])
def test_configs_equal_jax(name):
    assert _as_dict(getattr(tcfg, name)()) == _as_dict(getattr(jcfg, name)())


def test_yaml_and_overrides_match_jax(tmp_path):
    path = tmp_path / 'train.yaml'
    path.write_text('batch_size: 64\nlr_boundaries: [3, 5, 9]\n'
                    'compute_dtype: float32\n')
    for mod in (tcfg, jcfg):
        assert _as_dict(mod.load_yaml(str(path), mod.TrainConfig)) == \
            _as_dict(jcfg.load_yaml(str(path), jcfg.TrainConfig))
    (tmp_path / 'net.yaml').write_text(
        'num_keypoints: 11\nstage2: {num_modules: 1, num_branches: 2, '
        'num_blocks: [1, 1], num_channels: [16, 32]}\n')
    assert _as_dict(tcfg.load_yaml(str(tmp_path / 'net.yaml'))) == \
        _as_dict(jcfg.load_yaml(str(tmp_path / 'net.yaml')))
    good = [['batch_size=16', 'lr_boundaries=(4, 6, 8)', 'seed=3'],
            ['lr_boundaries=7'], ['compute_dtype=float32']]
    for ov in good:
        assert _as_dict(tcfg.apply_overrides(tcfg.TrainConfig(), ov)) == \
            _as_dict(jcfg.apply_overrides(jcfg.TrainConfig(), ov))
    assert _as_dict(tcfg.apply_overrides(
        tcfg.hrnet_tiny(), ['with_cbam=false', 'stage2.num_channels=(4,8)'])
    ) == _as_dict(jcfg.apply_overrides(
        jcfg.hrnet_tiny(), ['with_cbam=false', 'stage2.num_channels=(4,8)']))
    for bad in (['batch_size'], ['nope=1'], ['batch_size=x'],
                ['with_cbam=maybe']):
        cfg = (tcfg.hrnet_tiny() if 'cbam' in bad[0] else tcfg.TrainConfig())
        jc = (jcfg.hrnet_tiny() if 'cbam' in bad[0] else jcfg.TrainConfig())
        with pytest.raises(ValueError) as want:
            jcfg.apply_overrides(jc, bad)
        with pytest.raises(ValueError, match=str(want.value).split(':')[0]):
            tcfg.apply_overrides(cfg, bad)
