"""Fused CBAM of the port: its plain version (``cbam_plain``, what the
CUDA kernel ``csrc/cbam_fuse.cu`` is held to on the card) against the TPU
kernel run in the Pallas interpreter, the ``layers.CBAM`` dispatch, and
an f32 emulation of the kernel's cluster decomposition against the plain
version.

Tolerance: atol 1e-5 in f32 (the same f32 arithmetic; reductions are
summed in another order).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu.experimental.cbam_fuse import fused_cbam_pallas
from esa_pose_estimation_tpu_torch.experimental import cbam_fuse as cbam_fuse_mod
from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
    _SITE_RANKS,
    cbam_plain,
    cluster_ranks,
    fused_cbam,
)
from esa_pose_estimation_tpu_torch.models import layers


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _emulate_cluster(x, fc1, fc2, spw, res, ranks):
    """K2's decomposition (csrc/cbam_fuse.cu) in f32 torch: R bands of
    ceil(H/R) rows per image; per-rank channel partials combined in rank
    order; each rank's pooled maps in a window of its rows plus 3 halo
    rows a side, zero-bordered, the halo rows copied from the rank that
    owns them (zeros beyond the image); the 7x7 conv over each window."""
    b, h, w, c = x.shape
    band = -(-h // ranks)
    rows = [(r * band, max(0, min(band, h - r * band))) for r in range(ranks)]
    wconv = spw.permute(2, 0, 1)[None]                       # (1, 2, 7, 7)
    out = torch.empty_like(x)
    for i in range(b):
        xi = x[i]
        s = torch.zeros(c)
        m = torch.full((c,), -torch.inf)
        for r0, n in rows:                                   # rank order
            part = xi[r0:r0 + n].reshape(-1, c)
            s = s + part.sum(0)
            if n:
                m = torch.maximum(m, part.amax(0))
        cg = torch.sigmoid(torch.relu((s / (h * w)) @ fc1) @ fc2
                           + torch.relu(m @ fc1) @ fc2)
        xg = xi * cg
        wins = []
        for r0, n in rows:
            win = torch.zeros(2, band + 6, w + 6)
            if n:
                win[0, 3:3 + n, 3:3 + w] = xg[r0:r0 + n].mean(-1)
                win[1, 3:3 + n, 3:3 + w] = xg[r0:r0 + n].amax(-1)
            wins.append(win)
        for (r0, n), win in zip(rows, wins):
            if not n:
                continue
            for wr in (0, 1, 2, n + 3, n + 4, n + 5):
                y = r0 - 3 + wr
                if 0 <= y < h:
                    owner = y // band
                    win[:, wr] = wins[owner][:, 3 + y - owner * band]
            sg = torch.sigmoid(F.conv2d(win[None], wconv))[0, 0, :n, :, None]
            o = xg[r0:r0 + n] * sg
            if res is not None:
                o = torch.relu(o + res[i, r0:r0 + n])
            out[i, r0:r0 + n] = o
    return out


# (b, h, w, c, residual, ranks): the five hrnet_esa sites at the kernel's
# own cluster size, H that R does not divide (21 = 11 + 10 rows), bands
# of 3 rows (halo from two ranks) and empty ranks (10 rows over 8)
EMULATED = [(2, 64, 64, 32, True, 0), (2, 32, 32, 64, True, 0),
            (2, 16, 16, 128, True, 0), (2, 8, 8, 256, True, 0),
            (1, 128, 128, 64, False, 0), (3, 21, 36, 64, True, 0),
            (2, 20, 36, 64, True, 0), (2, 10, 12, 32, True, 4),
            (1, 10, 12, 32, False, 8)]


@pytest.mark.parametrize('b,h,w,c,with_res,ranks', EMULATED)
def test_cluster_decomposition_matches_plain(b, h, w, c, with_res, ranks):
    x, res, fc1, fc2, spw = (torch.from_numpy(a)
                             for a in _inputs(h + c, h, w, c, b=b))
    res = res if with_res else None
    got = _emulate_cluster(x, fc1, fc2, spw, res,
                           ranks or cluster_ranks(h, w, c))
    np.testing.assert_allclose(got.numpy(),
                               cbam_plain(x, fc1, fc2, spw, res).numpy(),
                               atol=1e-5)


def test_cluster_constants_mirror_the_cuda_source():
    """The module's cluster table and rule constants are the kernel's."""
    src = (Path(cbam_fuse_mod.__file__).resolve().parents[1] / 'csrc'
           / 'cbam_fuse.cu').read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (-?\d+);', src))
    assert (int(consts['kThreads']), int(consts['kMaxRanks']),
            int(consts['kBandBytes'])) == (cbam_fuse_mod._THREADS,
                                           cbam_fuse_mod._MAX_RANKS,
                                           cbam_fuse_mod._BAND_BYTES)
    table = src.split('kSiteRanks[5][4] = {')[1].split('};')[0]
    rows = {(int(h), int(w), int(c)): int(r) for h, w, c, r in
            re.findall(r'\{(\d+), (\d+), (\d+), (\d+)\}', table)}
    assert rows == _SITE_RANKS
    assert {int(consts[k]) for k in ('kErrShape', 'kErrSmem', 'kErrCluster',
                                     'kErrDevice')
            } == set(cbam_fuse_mod._ERRORS)
    # the default rule: the smallest power of two whose band fits
    assert [cluster_ranks(*s) for s in ((20, 36, 64), (21, 36, 64),
                                        (3, 8, 512), (256, 256, 64))] == \
        [2, 2, 1, 16]
    assert 'while (2 * B * r <= n_sm && 2 * r <= kMaxRanks && 2 * r <= H)' \
        in src
    # a batch that leaves SMs idle doubles R while B * 2R <= SMs
    assert [cluster_ranks(*s, batch=64, n_sm=132) for s in _SITE_RANKS] == \
        [5, 2, 2, 2, 16]
    assert cluster_ranks(8, 8, 256, batch=1, n_sm=132) == 8
    assert cluster_ranks(64, 64, 32, batch=1, n_sm=132) == 10
