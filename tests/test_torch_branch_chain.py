"""The branch chain of the port: its plain version (``branch_chain_plain``,
what the CUDA kernel ``csrc/branch_chain.cu`` is held to on the card)
against the JAX ``branch_chain_xla``, on the cases of
``tests/test_branch_chain.py``, with the weights carried across as numpy;
and the bf16 kernel's geometry (weight packing, tiles, halo, staged width,
slack, masking) emulated in f32 torch against the plain version.

Tolerances are JAX's own: rtol/atol 0.05 in bf16 (one bf16 step of h moves
the chain), rtol 1e-4 / atol 1e-5 in f32, rtol 1e-5 / atol 1e-6 for the
zero input and depth one.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.experimental import branch_chain as jbc
from esa_pose_estimation_tpu_torch.cli import mfu_experiments
from esa_pose_estimation_tpu_torch.experimental import branch_chain as tbc


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _unpack(packed):
    """Inverse of ``pack_weights`` by its documented index map:
    packed[i, j, t, g, co, c] = w[i, j, t // 3, t % 3, 8 g + c, co]."""
    k = packed.shape[0]
    w = torch.zeros((k, 2, 3, 3, 32, 32), dtype=packed.dtype)
    i, j, t, g, co, c = torch.meshgrid(
        *(torch.arange(n) for n in packed.shape), indexing='ij')
    w[i, j, t // 3, t % 3, 8 * g + c, co] = packed[i, j, t, g, co, c]
    return w


def test_pack_weights_unpacks_to_the_bf16_weights():
    """Exact: the packing only reorders the weights rounded to bf16."""
    w = torch.from_numpy(_chain(11, 2)[0])
    packed = tbc.pack_weights(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (2, 2, 9, 4, 32, 8)
    assert torch.equal(_unpack(packed), w.to(torch.bfloat16))


def _emulate_tc(x, weights, biases):
    """The bf16 kernel's arithmetic layout in f32 torch, tile by tile.

    Per 16x32 output tile: the x tile with a 2-pixel halo is staged as
    rows of ``_WS`` flattened positions (zero outside the image), then zero
    slack up to ``_X_POS``; conv 1 forms, for the ``_H_MTILES * _M`` h
    positions q, the A rows x_s[q + dy * _WS + dx] over the 9 taps (288
    columns) and multiplies them by the (288, 32) B matrix unpacked from
    ``pack_weights``; h is biased, rectified and zeroed outside the image;
    conv 2 does the same over the ``_O_MTILES * _M`` output positions of
    h, adds the bias and the staged residual, and keeps only the columns
    < ``_TILE_W`` inside the image.  Indexing past the buffers raises."""
    bsz, hh, ww, c = x.shape
    th, tw, ws = tbc._TILE_H, tbc._TILE_W, tbc._WS
    xr = th + 4
    offs = torch.tensor([dy * ws + dx for dy in range(3) for dx in range(3)])
    qh = torch.arange(tbc._H_MTILES * tbc._M)
    qo = torch.arange(tbc._O_MTILES * tbc._M)
    # B[i, j][tap * 32 + cin, co] from the packed order
    bmat = tbc.pack_weights(weights).float().permute(0, 1, 2, 3, 5, 4)
    bmat = bmat.reshape(weights.shape[0], 2, 9 * c, c)
    b = biases.float()

    def inside(yy, xx):
        return (yy >= 0) & (yy < hh) & (xx >= 0) & (xx < ww)

    cur = x.float()
    for i in range(weights.shape[0]):
        new = torch.full_like(cur, float('nan'))
        for img in range(bsz):
            for ty0 in range(0, hh, th):
                for tx0 in range(0, ww, tw):
                    yy = ty0 - 2 + torch.arange(xr)[:, None].expand(xr, ws)
                    xx = tx0 - 2 + torch.arange(ws)[None, :].expand(xr, ws)
                    stage = torch.where(
                        inside(yy, xx)[..., None],
                        cur[img, yy.clamp(0, hh - 1), xx.clamp(0, ww - 1)],
                        0.0)
                    xs = torch.zeros((tbc._X_POS, c))
                    xs[:xr * ws] = stage.reshape(-1, c)
                    a1 = xs[qh[:, None] + offs[None, :]].reshape(-1, 9 * c)
                    hin = inside(ty0 - 1 + qh // ws, tx0 - 1 + qh % ws)
                    hs = torch.where(hin[:, None],
                                     torch.relu(a1 @ bmat[i, 0] + b[i, 0]),
                                     0.0)
                    a2 = hs[qo[:, None] + offs[None, :]].reshape(-1, 9 * c)
                    orow, ocol = qo // ws, qo % ws
                    res = xs[(orow + 2) * ws + ocol + 2]
                    y = torch.relu(a2 @ bmat[i, 1] + b[i, 1] + res)
                    keep = ((ocol < tw) & (ty0 + orow < hh)
                            & (tx0 + ocol < ww))
                    new[img, ty0 + orow[keep], tx0 + ocol[keep]] = y[keep]
        cur = new
    return cur


@pytest.mark.parametrize('shape,k', [((2, 20, 40, 32), 2),
                                     ((1, 8, 8, 32), 1),
                                     ((1, 64, 64, 32), 1)])
def test_tc_geometry_emulation_equals_plain(shape, k):
    """The bf16 kernel's tiling, halo, staged width, slack and masking,
    emulated in f32 on shapes that are not multiples of the tile, equal
    the plain chain in f32 up to summation order (rtol 1e-5, atol 1e-6).
    The weights are rounded to bf16 first, so the packing is exact."""
    w, b = _chain(5 + k, k)
    w = torch.from_numpy(w).to(torch.bfloat16).float()
    x = torch.from_numpy(np.random.default_rng(k).normal(
        size=shape).astype(np.float32))
    got = _emulate_tc(x, w, torch.from_numpy(b))
    want = tbc.branch_chain_plain(x, w, torch.from_numpy(b))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_tile_constants_mirror_the_cuda_source():
    """The module's tile constants are those the kernel is compiled with."""
    src = (Path(tbc.__file__).resolve().parents[1] / 'csrc'
           / 'branch_chain.cu').read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (\d+);', src))
    assert (int(consts['kTileH']), int(consts['kTileW']), int(consts['kM'])
            ) == (tbc._TILE_H, tbc._TILE_W, tbc._M)
    assert 'constexpr int kWs = kTileW + 4;' in src
    assert (tbc._WS, tbc._H_MTILES, tbc._O_MTILES, tbc._X_POS) == (
        36, 11, 9, 784)
