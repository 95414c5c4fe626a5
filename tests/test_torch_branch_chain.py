"""The branch chain of the port: its plain version (``branch_chain_plain``,
what the CUDA kernel ``csrc/branch_chain.cu`` is held to on the card)
against the JAX ``branch_chain_xla``, on the cases of
``tests/test_branch_chain.py``, with the weights carried across as numpy.

Tolerances are JAX's own: rtol/atol 0.05 in bf16 (one bf16 step of h moves
the chain), rtol 1e-4 / atol 1e-5 in f32, rtol 1e-5 / atol 1e-6 for the
zero input and depth one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.experimental import branch_chain as jbc
from esa_pose_estimation_tpu_torch.cli import mfu_experiments
from esa_pose_estimation_tpu_torch.experimental import branch_chain as tbc


def _chain(seed, k, c=32):
    rng = np.random.default_rng(seed)
    w = (0.2 * rng.normal(size=(k, 2, 3, 3, c, c)) / np.sqrt(9.0 * c)
         ).astype(np.float32)
    b = (0.1 * rng.normal(size=(k, 2, c))).astype(np.float32)
    return w, b


def _both(x, w, b):
    want = jbc.branch_chain_xla(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = tbc.branch_chain_plain(torch.from_numpy(np.array(x)),
                                 torch.from_numpy(w), torch.from_numpy(b))
    return got, want


def test_k3_bf16_and_f32_match_xla():
    w, b = _chain(0, 3)
    x32 = np.random.default_rng(1).normal(size=(4, 16, 16, 32)
                                          ).astype(np.float32)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    want = jbc.branch_chain_xla(xb, jnp.asarray(w), jnp.asarray(b))
    got = tbc.branch_chain_plain(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
            torch.bfloat16), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (4, 16, 16, 32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)
    got32, want32 = _both(x32, w, b)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32),
                               rtol=1e-4, atol=1e-5)


def test_zero_input_passes_bias_path():
    w, b = _chain(7, 2)
    got, want = _both(np.zeros((2, 8, 8, 32), np.float32), w, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert float(got.abs().max()) > 0       # the chain actually fired


def test_depth_one_is_single_block():
    w, b = _chain(3, 1)
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 32)).astype(np.float32)
    got, want = _both(x, w, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    w, b = tbc.make_test_chain(gen, k=2, c=32)
    x = torch.randn((2, 8, 8, 32), generator=gen).to(torch.bfloat16)
    before = tbc.branch_chain.launches
    out = tbc.branch_chain(x, w, b)
    assert tbc.branch_chain.launches == before
    assert torch.equal(out, tbc.branch_chain_plain(x, w, b))


def test_make_test_chain_shapes_and_scale():
    gen = torch.Generator().manual_seed(1)
    w, b = tbc.make_test_chain(gen, k=4, c=32)
    assert w.shape == (4, 2, 3, 3, 32, 32) and b.shape == (4, 2, 32)
    # std 0.2 / sqrt(9 C), as the JAX draw
    assert abs(float(w.std()) - 0.2 / np.sqrt(288.0)) < 1e-3
    assert abs(float(b.std()) - 0.1) < 0.03


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; a tensor on another
    non-CUDA device raises before anything is built."""
    x = torch.empty((1, 8, 8, 32), device='meta')
    w, b = torch.empty((1, 2, 3, 3, 32, 32)), torch.empty((1, 2, 32))
    with pytest.raises(RuntimeError, match='unsupported device'):
        tbc.branch_chain(x, w, b)


def test_library_chain_is_the_same_function_in_f32():
    """The yardstick of ``chip_smoke.py`` and ``mfu_experiments --chain``
    (2k library convolutions) computes the chain: in f32 it equals the
    plain version to summation order."""
    gen = torch.Generator().manual_seed(3)
    w, b = tbc.make_test_chain(gen, k=2, c=32)
    x = torch.randn((2, 8, 8, 32), generator=gen)
    lib = mfu_experiments.library_chain(
        x.permute(0, 3, 1, 2), w.permute(0, 1, 5, 4, 2, 3), b)
    np.testing.assert_allclose(lib.permute(0, 2, 3, 1).numpy(),
                               tbc.branch_chain_plain(x, w, b).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_conv_flops_and_random_init():
    net = torch.nn.Sequential(torch.nn.Conv2d(4, 8, 3, padding=1),
                              torch.nn.Conv2d(8, 6, 1))
    mfu_experiments.init_random(net, torch.Generator().manual_seed(0))
    assert float(net[0].bias.detach().abs().max()) == 0.0
    # He-normal: std sqrt(2 / fan_in), fan_in = 4 * 3 * 3
    assert abs(float(net[0].weight.detach().std()) - np.sqrt(2 / 36)) < 0.05
    flops = mfu_experiments.conv_flops(net, torch.zeros((2, 4, 5, 5)))
    assert flops == 2 * (2 * 8 * 25 * 36 + 2 * 6 * 25 * 8)


def test_experiments_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the refusal is for none')
    with pytest.raises(SystemExit, match='no CUDA device'):
        mfu_experiments.main(['--chain'])
