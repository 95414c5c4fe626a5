"""Fused CBAM of the port: its plain version (``cbam_plain``, what the
CUDA kernel ``csrc/cbam_fuse.cu`` is held to on the card) against the TPU
kernel run in the Pallas interpreter, and the ``layers.CBAM`` dispatch.

Tolerance: atol 1e-5 in f32 (the same f32 arithmetic; reductions are
summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.experimental.cbam_fuse import fused_cbam_pallas
from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
    cbam_plain,
    fused_cbam,
)
from esa_pose_estimation_tpu_torch.models import layers


def _inputs(seed, h, w, c, b=2):
    rng = np.random.default_rng(seed)
    hid = max(c // 16, 1)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    res = rng.normal(size=(b, h, w, c)).astype(np.float32)
    fc1 = rng.normal(size=(c, hid), scale=0.3).astype(np.float32)
    fc2 = rng.normal(size=(hid, c), scale=0.3).astype(np.float32)
    spw = rng.normal(size=(7, 7, 2), scale=0.2).astype(np.float32)
    return x, res, fc1, fc2, spw


@pytest.mark.parametrize('hwc', [(64, 64, 32), (32, 32, 64),
                                 (16, 16, 128), (8, 8, 256)])
def test_plain_matches_tpu_kernel_interpreted(hwc):
    x, res, fc1, fc2, spw = _inputs(sum(hwc), *hwc)
    want = fused_cbam_pallas(*(jnp.asarray(a) for a in (x, fc1, fc2, spw,
                                                         res)),
                             interpret=True)
    got = cbam_plain(*(torch.from_numpy(a) for a in (x, fc1, fc2, spw, res)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_without_residual_keeps_negatives():
    x, _, fc1, fc2, spw = _inputs(1, 16, 16, 32)
    want = fused_cbam_pallas(*(jnp.asarray(a) for a in (x, fc1, fc2, spw)),
                             None, interpret=True)
    got = cbam_plain(*(torch.from_numpy(a) for a in (x, fc1, fc2, spw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got.min()) < 0


def test_wrapper_on_cpu_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(2, 8, 8, 64)]
    x, res, fc1, fc2, spw = args
    before = fused_cbam.launches
    out = fused_cbam(x.to(torch.bfloat16), fc1, fc2, spw,
                     res.to(torch.bfloat16))
    assert fused_cbam.launches == before
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, cbam_plain(x.to(torch.bfloat16), fc1, fc2, spw,
                                       res.to(torch.bfloat16)))


@pytest.mark.parametrize('with_residual', [True, False])
def test_module_dispatch_matches_composite(with_residual, monkeypatch):
    torch.manual_seed(0)
    mod = layers.CBAM(64).eval()
    x = torch.randn(2, 64, 16, 16)
    res = torch.randn(2, 64, 16, 16) if with_residual else None
    monkeypatch.setattr(layers, 'FUSED_CBAM', False)
    with torch.no_grad():
        slow = mod(x, res)
    monkeypatch.setattr(layers, 'FUSED_CBAM', True)
    with torch.no_grad():
        fast = mod(x, res)
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), atol=1e-5)
    # training mode never takes the fused path (it has no autograd)
    mod.train()
    calls = []
    monkeypatch.setattr(layers, 'fused_cbam',
                        lambda *a, **k: calls.append(1))
    mod(x, res)
    assert not calls
