"""Port weights: the artifact reader and the Flax-tree -> state_dict mapping
of ``esa_pose_estimation_tpu_torch`` against the JAX package's loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.utils import config as jax_cfg
from esa_pose_estimation_tpu.utils.artifact import load_inference_artifact
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.utils import config as cfg
from esa_pose_estimation_tpu_torch.utils.artifact import (
    _flatten,
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


ARTIFACT = 'artifacts/esa_syn_r5.npz'


def _assert_maps_exactly(variables, model):
    sd = from_jax_variables(variables)
    want = model.state_dict()
    assert set(sd) == set(want), (sorted(set(sd) - set(want))[:5],
                                  sorted(set(want) - set(sd))[:5])
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    n_leaves = sum(len(_flatten(variables[c]))
                   for c in ('params', 'batch_stats'))
    assert n_leaves == len(sd)


def test_reader_matches_jax_loader_bitwise():
    jv, jmeta = load_inference_artifact(ARTIFACT)
    tv, tmeta = read_artifact(ARTIFACT)
    assert tmeta == jmeta
    for coll in ('params', 'batch_stats'):
        jf = _flatten(jv[coll])
        tf = _flatten(tv[coll])
        assert set(jf) == set(tf)
        for k in jf:
            a = np.asarray(jf[k])
            assert tf[k].dtype == np.float32
            np.testing.assert_array_equal(tf[k], a, err_msg=k)


def test_r5_artifact_maps_every_leaf_hrnet_esa():
    tv, _ = read_artifact(ARTIFACT)
    _assert_maps_exactly(tv, HRNet(cfg.hrnet_esa()))


def test_tiny_init_maps_every_leaf():
    model = JaxHRNet(jax_cfg.hrnet_tiny())
    # the variable tree's structure and shapes, without running init
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 1)), train=False),
        jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _assert_maps_exactly(variables, HRNet(cfg.hrnet_tiny()))


def test_conv_kernel_layout_and_values():
    """HWIO -> OIHW, and the spatial gate keeps [mean, max] channel order."""
    tv, _ = read_artifact(ARTIFACT)
    sd = from_jax_variables(tv)
    k = tv['params']['CBAM_0']['SpatialAttention_0']['Conv_0']['kernel']
    assert k.shape == (7, 7, 2, 1)
    w = sd['CBAM_0.SpatialAttention_0.Conv_0.weight'].numpy()
    assert w.shape == (1, 2, 7, 7)
    np.testing.assert_array_equal(w[0, 0], k[:, :, 0, 0])   # mean channel
    np.testing.assert_array_equal(w[0, 1], k[:, :, 1, 0])   # max channel
    fc1 = tv['params']['CBAM_0']['ChannelAttention_0']['Conv_0']['kernel']
    assert fc1.shape == (1, 1, 64, 4)
    assert 'output_conv.bias' in sd and 'stem_conv1.bias' not in sd
    bn = tv['batch_stats']['stem_bn1']
    np.testing.assert_array_equal(sd['stem_bn1.running_var'].numpy(),
                                  bn['var'])


def test_loader_dtypes_and_device():
    model = load_hrnet_artifact(ARTIFACT, device='cpu')
    assert not model.training
    assert model.stem_conv1.weight.dtype == torch.bfloat16
    assert model.stem_bn1.running_mean.dtype == torch.float32
    assert model.output_conv.weight.device.type == 'cpu'


def test_loader_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='cuda'):
        load_hrnet_artifact(ARTIFACT)
