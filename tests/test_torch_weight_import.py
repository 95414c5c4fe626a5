"""Reference torch checkpoints into the port (``utils/torch_import.py``)
against the JAX package's ``utils/torch_import.py``.

A reference state_dict is made by the JAX exporter from random Flax
variables (the port's seeded models through ``to_jax_variables``:
``hrnet_tiny``; ResNet-8s at depth 18 with narrow decoder
widths), with a non-zero bias on every folded head conv and a 3-channel
stem kernel on the grey HRNet, so that the bias fold and the grey
adaptation both act.

Tolerances:
- the JAX import followed by ``from_jax_variables`` equals the port's
  import of the same state_dict key for key, exactly (``torch.equal``);
- the forward of the two imported models: atol 1e-5;
- the port's export equals the JAX export of the same weights exactly,
  and an export -> import round trip gives back every tensor exactly;
- a missing key raises ``KeyError``, an unconsumed key ``ValueError``;
- ``load_torch_checkpoint`` reads a ``torch.save`` of the reference's
  ``{'net': {'module.' + k: v}, 'epoch': ...}`` wrapper back exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu.utils import torch_import as jti
from esa_pose_estimation_tpu_torch.models import resnet8s as tr8
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils import torch_import as tti
from esa_pose_estimation_tpu_torch.utils.artifact import (
    from_jax_variables,
    to_jax_variables,
)

NARROW = dict(depth=18, fc_dim=16, s8_dim=16, s4_dim=8, s2_dim=8, raw_dim=8)


def _random(variables, seed):
    """The initialisation moved by noise (activations stay of order 1),
    running means of order 0.1 and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {'params': jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        variables['params'])}
    out['batch_stats'] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == 'var'
                      else 0.1 * rng.normal(size=a.shape)).astype(
                          np.float32), variables['batch_stats'])
    return out


def _flax_tree(model):
    """The Flax variable tree of a port model, seeded (``to_jax_variables``
    gives the JAX package's tree: tests/test_torch_train.py and
    test_torch_resnet8s.py hold it to JAX's ``init``; a wrong path would
    fail the JAX import or the JAX forward here).  JAX's own ``init``
    costs about a minute on one core."""
    model.init_weights(torch.Generator().manual_seed(0))
    return to_jax_variables(model)


@pytest.fixture(scope='module')
def hrnet():
    """(JAX model, random variables, reference state_dict as numpy with a
    folded bias and an RGB stem)."""
    model = JaxHRNet(jcfg.hrnet_tiny())
    variables = _random(_flax_tree(HRNet(tcfg.hrnet_tiny())), 1)
    sd = jti.export_reference_hrnet(variables, jcfg.hrnet_tiny())
    rng = np.random.default_rng(2)
    for k in ('last_layer.0.bias', 'last_layer.3.bias'):
        sd[k] = 0.1 * rng.normal(size=sd[k].shape).astype(np.float32)
    sd['conv1.weight'] = 0.1 * rng.normal(
        size=(sd['conv1.weight'].shape[0], 3) + sd['conv1.weight'].shape[2:]
    ).astype(np.float32)
    return model, variables, sd


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _jax_import(variables, sd):
    zeros = jax.tree.map(np.zeros_like, variables)
    return jti.import_reference_hrnet(zeros, sd, jcfg.hrnet_tiny())


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_hrnet_import_equals_jax_exactly(hrnet):
    _, variables, sd = hrnet
    want = from_jax_variables(_jax_import(variables, sd))
    model = tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()),
                                       _torch_sd(sd))
    _assert_sd_equal(model.state_dict(), want)
    # the fold and the grey sum acted
    assert not torch.equal(model.state_dict()['ConvBN_1.BatchNorm_0.'
                                              'running_mean'],
                           torch.from_numpy(sd['last_layer.1.running_mean']))
    assert model.state_dict()['stem_conv1.weight'].shape[1] == 1


def test_hrnet_import_forward_matches_jax(hrnet):
    jmodel, variables, sd = hrnet
    jvars = _jax_import(variables, sd)
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        jvars, jnp.asarray(x)))
    model = tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()),
                                       _torch_sd(sd)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_hrnet_export_round_trip_exact(hrnet):
    _, variables, sd = hrnet
    jvars = _jax_import(variables, sd)
    model = tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()),
                                       _torch_sd(sd))
    exported = tti.export_reference_hrnet(model)
    want = _torch_sd(jti.export_reference_hrnet(jvars, jcfg.hrnet_tiny()))
    _assert_sd_equal(exported, want)
    assert not exported['last_layer.0.bias'].any()    # folded: zeros
    back = tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()), exported)
    _assert_sd_equal(back.state_dict(), model.state_dict())


def test_hrnet_missing_and_unconsumed_keys_raise(hrnet):
    _, _, sd = hrnet
    tsd = _torch_sd(sd)
    missing = dict(tsd)
    del missing['stage2.0.fuse_layers.0.1.0.weight']
    with pytest.raises(KeyError, match='missing key'):
        tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()), missing)
    extra = dict(tsd, **{'aux_head.weight': torch.zeros(3),
                         'bn1.num_batches_tracked': torch.tensor(5)})
    with pytest.raises(ValueError, match='unconsumed'):
        tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()), extra)
    # num_batches_tracked alone is ignored; strict=False lets extras by
    tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()), dict(
        tsd, **{'bn1.num_batches_tracked': torch.tensor(5)}))
    tti.import_reference_hrnet(HRNet(tcfg.hrnet_tiny()), extra,
                               strict=False)


def test_plans_equal_jax():
    """Every plan mirrors the JAX one, operation for operation."""
    for cfg in (tcfg.hrnet_tiny(), tcfg.hrnet_esa()):
        jc = getattr(jcfg, 'hrnet_tiny' if cfg.stage1.num_channels[0] !=
                     tcfg.hrnet_esa().stage1.num_channels[0]
                     else 'hrnet_esa')()
        assert tti.hrnet_plan(cfg) == jti.hrnet_plan(jc)
    for depth in (18, 34, 50):
        assert tti.resnet_plan(depth) == jti.resnet_plan(depth)
        assert tti.resnet8s_net_plan(depth) == jti.resnet8s_net_plan(depth)


@pytest.fixture(scope='module')
def resnet():
    """Random variables of one JAX ResNet8s (8 output channels, which is
    also the trunk of a 2o net with seg_dim 2 and ver_dim 6)."""
    return _random(_flax_tree(tr8.ResNet8s(ver_dim=8, **NARROW)), 5)


@pytest.mark.parametrize('two_out', [False, True])
def test_resnet8s_import_equals_jax_exactly(resnet, two_out):
    """The whole reference Resnet18_8s (and the 2o net under its trunk's
    scope): JAX import -> from_jax_variables equals the port's import."""
    if two_out:
        variables = {k: {'ResNet8s_0': v} for k, v in resnet.items()}
        tm = tr8.ResNet8s2o(ver_dim=6, seg_dim=2, **NARROW)
        scope = ('ResNet8s_0',)
    else:
        variables, scope = resnet, ()
        tm = tr8.ResNet8s(ver_dim=8, **NARROW)
    sd = jti.export_plan(variables, jti.resnet8s_net_plan(18), scope=scope)
    sd['convraw.3.bias'] = np.arange(sd['convraw.3.bias'].size,
                                     dtype=np.float32)
    zeros = jax.tree.map(np.zeros_like, variables)
    want = from_jax_variables(jti.import_reference_resnet8s(
        zeros, sd, depth=18, scope=scope))
    got = tti.import_reference_resnet8s(tm, _torch_sd(sd), depth=18,
                                        scope=scope).state_dict()
    _assert_sd_equal(got, want)
    with pytest.raises(ValueError, match='unconsumed'):
        tti.import_reference_resnet8s(tm, dict(_torch_sd(sd), extra=torch.
                                               zeros(1)), scope=scope)


def test_torchvision_resnet_import_equals_jax_exactly(resnet):
    """A torchvision resnet18 state_dict (with its fc, which is left out)
    seeds the backbone only; the decoder keeps its weights."""
    tm = tr8.ResNet8s(ver_dim=8, **NARROW)
    tm.load_state_dict(from_jax_variables(resnet))
    scope = ('ResNetBackbone8s_0',)
    sd = jti.export_plan(_random(resnet, 8), jti.resnet_plan(18),
                         scope=scope)
    sd['fc.weight'] = np.zeros((1000, 512), np.float32)
    sd['fc.bias'] = np.zeros((1000,), np.float32)
    want = from_jax_variables(jti.import_torchvision_resnet(resnet, sd, 18))
    got = tti.import_torchvision_resnet(tm, _torch_sd(sd), 18).state_dict()
    _assert_sd_equal(got, want)
    assert torch.equal(got['Conv_0.weight'],
                       from_jax_variables(resnet)['Conv_0.weight'])
    assert not torch.equal(got['ResNetBackbone8s_0.Conv_0.weight'],
                           from_jax_variables(resnet)[
                               'ResNetBackbone8s_0.Conv_0.weight'])


def test_load_torch_checkpoint_unwraps(tmp_path, hrnet):
    _, _, sd = hrnet
    tsd = _torch_sd(sd)
    path = tmp_path / 'ref.pth'
    torch.save({'net': {'module.' + k: v for k, v in tsd.items()},
                'epoch': 3}, path)
    got = tti.load_torch_checkpoint(str(path))
    _assert_sd_equal(got, tsd)
    bare = tmp_path / 'bare.pth'
    torch.save(tsd, bare)
    _assert_sd_equal(tti.load_torch_checkpoint(str(bare)), tsd)
    # the JAX loader reads the same file to the same values
    jgot = jti.load_torch_checkpoint(str(path))
    assert set(jgot) == set(tsd)
    for k in tsd:
        np.testing.assert_array_equal(jgot[k], tsd[k].numpy())
