"""``obs/profiling.py`` of the port against the JAX package's.

Tolerances: parameter counts per top-level module and in total equal the
JAX ones on ``hrnet_tiny``; the FLOPs of one forward equal the count made
from the convolutions' shapes (2 per multiply-add) exactly; precision and
recall equal the JAX accumulator's exactly; a span lasts at least as
long as the work it waits for.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.obs import profiling as jprof
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.obs import profiling as tprof
from esa_pose_estimation_tpu_torch.utils import config as tcfg


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_param_counts_equal_jax():
    jm = JaxHRNet(jcfg.hrnet_tiny())
    # shapes only: param_count reads leaf shapes, so no compile is needed
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    model = HRNet(tcfg.hrnet_tiny())
    assert tprof.param_count(model) == jprof.param_count(variables['params'])
    s = tprof.model_summary(model, (1, 32, 32, 1))
    assert s['total_params'] == jprof.param_count(variables['params'])
    assert s['per_module'] == {
        name: jprof.param_count(sub)
        for name, sub in variables['params'].items()}


def test_model_summary_flops_from_shapes(monkeypatch):
    """Convolutions (forward hooks) and the einsum products of the
    align-corners resize, each 2 x its multiply-adds from the shapes."""
    model = HRNet(tcfg.hrnet_tiny()).eval()
    counted = []
    einsum = torch.einsum

    def counting_einsum(eq, *ops):
        sizes = {}
        for letters, t in zip(eq.split('->')[0].split(','), ops):
            sizes.update(zip(letters, t.shape))
        counted.append(2 * int(np.prod(list(sizes.values()))))
        return einsum(eq, *ops)

    monkeypatch.setattr(torch, 'einsum', counting_einsum)

    def hook(m, inputs, out):
        w = m.weight
        counted.append(2 * out.numel() * w.shape[1] * w.shape[2]
                       * w.shape[3])

    for m in model.modules():
        w = getattr(m, 'weight', None)
        if isinstance(w, torch.Tensor) and w.dim() == 4:
            m.register_forward_hook(hook)
    s = tprof.model_summary(model, (2, 32, 32, 1))
    assert counted and s['flops'] == sum(counted)
    assert not model.training


def test_precision_recall_equal_jax():
    rng = np.random.default_rng(0)
    jm, tm = jprof.MultiClassPrecisionRecall(4), \
        tprof.MultiClassPrecisionRecall(4)
    for _ in range(3):
        pred, target = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
        jm.update(pred, target)
        tm.update(torch.from_numpy(pred).numpy(), target)
    np.testing.assert_array_equal(tm.precision(), jm.precision())
    np.testing.assert_array_equal(tm.recall(), jm.recall())
    tm.reset()
    assert not tm.tp.any()


def test_timer_spans_cover_the_work(tmp_path):
    t = tprof.Timer()
    with t.span() as s:
        time.sleep(0.02)
        s.result = {'a': torch.ones(4), 'b': [torch.zeros(2)]}
    with t.span(result=torch.ones(2)):
        pass
    assert len(t.times) == 2 and t.times[0] >= 0.02
    assert t.total >= t.mean > 0
    with tprof.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert list(tmp_path.iterdir())          # a trace file was written
