"""The port's HRNet layers against the Flax ones, on the same weights.

Everything runs in f32 in both frameworks: there the point is the
algorithm (bf16 rounds at other places in the two frameworks).  Layers
and blocks within atol 1e-5.  On randomized parameters and BatchNorm
statistics: the fuse layer at rtol/atol 2e-5 in eval mode, and in train
mode its outputs and updated running statistics at atol and rtol 1e-5
(``test_torch_train.py``'s train-mode tolerance); the whole ``hrnet_tiny``
in eval mode at its output's scale, rtol 1e-4 / atol 1e-5
(tests/test_models.py:144-185).  The full hrnet_esa forward on the r5
weights is held to the Flax model in ``test_torch_pipeline.py``, which
shares the JAX run of the whole slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.models import hrnet as jhrnet
from esa_pose_estimation_tpu.models import layers as jlayers
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch.models import hrnet as thrnet
from esa_pose_estimation_tpu_torch.models import layers as tlayers
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


@pytest.mark.parametrize('scale', [2, 4, 8])
def test_resize_half_pixel_matches_jax_image_resize(scale):
    """F.interpolate(align_corners=False) equals jax.image.resize for the
    network's upsamplings, border rows and columns included."""
    rng = np.random.default_rng(scale)
    x = rng.normal(size=(2, 5, 128 // (2 * scale), 128 // (2 * scale))
                   ).astype(np.float32)
    out = (x.shape[2] * scale, x.shape[3] * scale)
    want = np.asarray(jlayers.resize_bilinear(
        jnp.asarray(x.transpose(0, 2, 3, 1)), out)).transpose(0, 3, 1, 2)
    got = tlayers.resize_bilinear(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[..., 0, :], want[..., 0, :], atol=1e-5)
    np.testing.assert_allclose(got[..., :, -1], want[..., :, -1], atol=1e-5)


@pytest.mark.parametrize('shape', [(64, 128), (8, 16), (1, 4)])
def test_resize_align_corners_matches(shape):
    h, oh = shape
    x = np.random.default_rng(h).normal(size=(2, 3, h, h)).astype(np.float32)
    want = np.asarray(jlayers.resize_bilinear(
        jnp.asarray(x.transpose(0, 2, 3, 1)), (oh, oh),
        align_corners=True)).transpose(0, 3, 1, 2)
    got = tlayers.resize_bilinear(torch.from_numpy(x), (oh, oh),
                                  align_corners=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _port_block(jax_module, torch_module, x_nhwc):
    variables = jax.jit(lambda k, a: jax_module.init(k, a, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x_nhwc))
    # random BN statistics, so the f32 BatchNorm path is exercised
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, variables)
    variables['batch_stats'] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables['batch_stats'])
    torch_module.load_state_dict(from_jax_variables(variables), strict=True)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x_nhwc),
                                       train=False))
    with torch.no_grad():
        got = torch_module.eval()(torch.from_numpy(
            x_nhwc.transpose(0, 3, 1, 2).copy()))
    return got.numpy().transpose(0, 2, 3, 1), want


@pytest.mark.parametrize('block,cin,features,stride', [
    ('BASIC', 16, 16, 1), ('BASIC', 16, 32, 2), ('BOTTLENECK', 16, 8, 1)])
def test_blocks_match(block, cin, features, stride):
    x = np.random.default_rng(1).normal(size=(2, 16, 16, cin)).astype(
        np.float32)
    jblk = {'BASIC': jlayers.BasicBlock,
            'BOTTLENECK': jlayers.Bottleneck}[block](features=features,
                                                    stride=stride)
    tblk = tlayers.BLOCKS[block](cin, features, stride=stride)
    got, want = _port_block(jblk, tblk, x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _randomized(init_fn, seed, *args):
    """Every parameter and BN statistic drawn with numpy: normal * 0.3,
    the 1-D leaves |.| + 0.5, so no BatchNorm is near the identity.  The
    tree's shapes come from ``jax.eval_shape``, so nothing is compiled for
    the init."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(leaf):
        r = rng.normal(size=leaf.shape).astype(np.float32) * 0.3
        return np.abs(r) + 0.5 if leaf.ndim == 1 else r

    return jax.tree.map(draw, shapes)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('branches', [2, 3, 4])
def test_fuse_layer_matches_jax(branches, train):
    """Every path of the cross-resolution fusion (1x1 conv + BN and
    upsample, identity, chains of strided 3x3 convs); in train mode the
    batch statistics and each updated running statistic too."""
    chans = (8, 16, 32, 64)[:branches]
    rng = np.random.default_rng(10 + branches)
    xs = [rng.normal(size=(2, 32 >> i, 32 >> i, c)).astype(np.float32)
          for i, c in enumerate(chans)]
    jlayer = jhrnet.FuseLayer(branches, chans)
    jxs = [jnp.asarray(x) for x in xs]
    variables = _randomized(lambda k, a: jlayer.init(k, a, train=False),
                            branches, jxs)
    layer = thrnet.FuseLayer(branches, chans).train(train)
    layer.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = layer([torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
                     for x in xs])
    if train:
        want, mutated = jax.jit(lambda v, a: jlayer.apply(
            v, a, train=True, mutable=['batch_stats']))(variables, jxs)
    else:
        want = jax.jit(lambda v, a: jlayer.apply(v, a, train=False))(
            variables, jxs)
    tol = 1e-5 if train else 2e-5
    assert len(got) == branches
    for i in range(branches):
        np.testing.assert_allclose(got[i].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want[i]), rtol=tol, atol=tol,
                                   err_msg=str(i))
    if train:
        stats = from_jax_variables({'batch_stats': jax.tree.map(
            np.asarray, mutated['batch_stats'])})
        before = from_jax_variables(
            {'batch_stats': variables['batch_stats']})
        sd = layer.state_dict()
        for k, w in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
            assert not np.array_equal(w.numpy(), before[k].numpy()), k


def test_tiny_net_matches_jax_on_randomized_statistics():
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    jm = JaxHRNet(jcfg.hrnet_tiny())
    variables = _randomized(lambda k, a: jm.init(k, a, train=False), 3,
                            jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    model = thrnet.HRNet(tcfg.hrnet_tiny()).eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # randomized BN statistics blow activations up through the net:
    # compare at the output's own scale, as the JAX test does
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4,
                               atol=1e-5)
