"""Fused CBAM of the port: its plain version (``cbam_plain``, what the
CUDA kernel ``csrc/cbam_fuse.cu`` is held to on the card) against the TPU
kernel run in the Pallas interpreter, the ``layers.CBAM`` dispatch and its
rule, the wrapper's marshalling of the stored weights to the launch, and
an f32 emulation of the kernel's cluster decomposition against the plain
version.

Tolerance: atol 1e-5 in f32 (the same f32 arithmetic; reductions are
summed in another order).
"""

import contextlib
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
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.utils import config as tcfg


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


def _conv_layout(fc1, fc2, spw):
    """The TPU kernel's (C, C/16), (C/16, C), (7, 7, 2) weights as the
    port's convs store them: (C/16, C, 1, 1), (C, C/16, 1, 1),
    (1, 2, 7, 7)."""
    fc1, fc2, spw = (torch.as_tensor(a) for a in (fc1, fc2, spw))
    return (fc1.t()[:, :, None, None].contiguous(),
            fc2.t()[:, :, None, None].contiguous(),
            spw.permute(2, 0, 1)[None].contiguous())


@pytest.mark.parametrize('hwc', [(64, 64, 32), (32, 32, 64),
                                 (16, 16, 128), (8, 8, 256)])
def test_plain_matches_tpu_kernel_interpreted(hwc):
    x, res, fc1, fc2, spw = _inputs(sum(hwc), *hwc)
    want = fused_cbam_pallas(*(jnp.asarray(a) for a in (x, fc1, fc2, spw,
                                                         res)),
                             interpret=True)
    got = cbam_plain(torch.from_numpy(x), *_conv_layout(fc1, fc2, spw),
                     torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_without_residual_keeps_negatives():
    x, _, fc1, fc2, spw = _inputs(1, 16, 16, 32)
    want = fused_cbam_pallas(*(jnp.asarray(a) for a in (x, fc1, fc2, spw)),
                             None, interpret=True)
    got = cbam_plain(torch.from_numpy(x), *_conv_layout(fc1, fc2, spw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got.min()) < 0


def test_wrapper_on_cpu_is_the_plain_version():
    x, res, *weights = _inputs(2, 8, 8, 64)
    x, res = torch.from_numpy(x), torch.from_numpy(res)
    fc1, fc2, spw = _conv_layout(*weights)
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


def _row_threads(w, c):
    """row_threads in csrc/cbam_fuse.cu: step 2's threads per row and
    16-byte vector of channels."""
    t = 1
    while 16 * t <= w and 2 * t * (c // 8) <= cbam_fuse_mod._THREADS:
        t *= 2
    return t


def _row_sums(xi):
    """Step 2 of the kernel in its own order: each row's channel sums, the
    columns k, k + tpr, ... in turn per thread k, a butterfly over the k of
    a warp, then the warps' groups in order."""
    h, w, c = xi.shape
    tpr = _row_threads(w, c)
    vpp = c // 8
    kf = min(tpr, 1 if vpp >= 32 else 32 // vpp)
    s = torch.zeros(h, tpr, c)
    for col in range(0, w, tpr):
        part = xi[:, col:col + tpr]
        s[:, :part.shape[1]] += part
    s = s.reshape(h, tpr // kf, kf, c)
    while s.shape[2] > 1:                        # xor offsets 1, 2, 4, ...
        s = s[:, :, 0::2] + s[:, :, 1::2]
    rows = torch.zeros(h, c)
    for q in range(tpr // kf):
        rows = rows + s[:, q, 0]
    return rows


def _gathered_channel_sums(xi, ranks):
    """Steps 2 and 3: each rank publishes its band's row sums; thread
    (q, c) of every rank reads the rows of chunk q from their owners and
    adds them in order, then the chunks are added in order."""
    h, w, c = xi.shape
    band = -(-h // ranks)
    rows = _row_sums(xi)
    psum = [rows[r * band:(r + 1) * band] for r in range(ranks)]
    parts = max(1, cbam_fuse_mod._THREADS // c)
    chunk = -(-h // parts)
    s = torch.zeros(c)
    for q in range(parts):
        part = torch.zeros(c)
        for y in range(q * chunk, min(h, (q + 1) * chunk)):
            part = part + psum[y // band][y - y // band * band]
        s = s + part
    return s


def _emulate_cluster(x, fc1, fc2, spw, res, ranks):
    """K2's decomposition (csrc/cbam_fuse.cu) in f32 torch: R bands of
    ceil(H/R) rows per image; the channel sums of each row in the kernel's
    order, gathered from their ranks and added in row order; each rank's
    pooled maps in a window of its rows plus 3 halo rows a side,
    zero-bordered, the halo rows copied from the rank that owns them
    (zeros beyond the image); the 7x7 conv over each window."""
    b, h, w, c = x.shape
    band = -(-h // ranks)
    rows = [(r * band, max(0, min(band, h - r * band))) for r in range(ranks)]
    w1, w2 = fc1[:, :, 0, 0].t(), fc2[:, :, 0, 0].t()    # (C, C/16), (C/16, C)
    out = torch.empty_like(x)
    for i in range(b):
        xi = x[i]
        s = _gathered_channel_sums(xi, ranks)
        m = xi.reshape(-1, c).amax(0)
        cg = torch.sigmoid(torch.relu((s / (h * w)) @ w1) @ w2
                           + torch.relu(m @ w1) @ w2)
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
            sg = torch.sigmoid(F.conv2d(win[None], spw))[0, 0, :n, :, None]
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
    x, res, *weights = _inputs(h + c, h, w, c, b=b)
    x, res = torch.from_numpy(x), torch.from_numpy(res)
    fc1, fc2, spw = _conv_layout(*weights)
    res = res if with_res else None
    got = _emulate_cluster(x, fc1, fc2, spw, res,
                           ranks or cluster_ranks(h, w, c))
    np.testing.assert_allclose(got.numpy(),
                               cbam_plain(x, fc1, fc2, spw, res).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize('h,w,c', [(64, 64, 32), (32, 32, 64), (8, 8, 256),
                                   (128, 128, 64), (21, 36, 64), (10, 12, 32)])
def test_channel_sums_do_not_depend_on_ranks(h, w, c):
    """The kernel's channel sums, gathered from bands of any R, are the
    same bits: an image's gate does not depend on the cluster size, which
    follows the batch."""
    xi = torch.from_numpy(_inputs(h * c, h, w, c, b=1)[0][0])
    want = _gathered_channel_sums(xi, 1)
    for ranks in (2, 3, 5, 8, 16):
        if ranks <= h:
            assert torch.equal(_gathered_channel_sums(xi, ranks), want)
    np.testing.assert_allclose(want.numpy(),
                               xi.double().sum((0, 1)).numpy(), rtol=1e-5,
                               atol=1e-4)


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
                                     'kErrDevice', 'kErrDtype')
            } == set(cbam_fuse_mod._ERRORS)
    assert (int(consts['kWeightF32']), int(consts['kWeightBf16'])) == (
        cbam_fuse_mod._WEIGHT_DTYPES[torch.float32],
        cbam_fuse_mod._WEIGHT_DTYPES[torch.bfloat16])
    # the default rule: the smallest power of two whose band fits
    assert [cluster_ranks(*s) for s in ((20, 36, 64), (21, 36, 64),
                                        (3, 8, 512), (256, 256, 64))] == \
        [2, 2, 1, 16]
    assert 'while (2 * B * r <= n_sm && 2 * r <= kMaxRanks && 2 * r <= H)' \
        in src
    # step 2's threads per row (_row_threads)
    assert 'while (16LL * t <= W && 2LL * t * (C / 8) <= kThreads) t *= 2;' \
        in src
    assert [_row_threads(*s[1:]) for s in _SITE_RANKS] == [8, 4, 2, 1, 16]
    # a batch that leaves SMs idle doubles R while B * 2R <= SMs
    assert [cluster_ranks(*s, batch=64, n_sm=132) for s in _SITE_RANKS] == \
        [5, 2, 2, 2, 16]
    assert cluster_ranks(8, 8, 256, batch=1, n_sm=132) == 8
    assert cluster_ranks(64, 64, 32, batch=1, n_sm=132) == 10


# --- the dispatch rule and the launch's marshalling --------------------------

def _tiny_hrnet():
    return HRNet(tcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0)).eval()


def _spy(monkeypatch, name):
    """Replace ``layers.<name>`` by a pass-through that records its calls."""
    calls = []
    real = getattr(layers, name)

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(layers, name, spy)
    return calls


def _rule(training=False, device='cuda', dtype=torch.bfloat16,
          needs_grad=False, channels=64):
    return layers.takes_fused_cbam(training, torch.device(device), dtype,
                                   needs_grad, channels)


@pytest.mark.parametrize('case', ['cpu_default_is_plain', 'forced_on',
                                  'forced_off', 'training', 'needs_grad',
                                  'cuda_bf16_eval'])
def test_fused_cbam_dispatch_rule(case, monkeypatch):
    """``FUSED_CBAM``'s default (None) runs K2 only for an eval-mode CUDA
    bf16 input that needs no gradient, with C a power of two in [8, 4096];
    True and False force either path outside training."""
    assert layers.FUSED_CBAM is None
    torch.manual_seed(0)
    x = torch.randn(2, 32, 16, 16)
    res = torch.randn(2, 32, 16, 16)
    mod = layers.CBAM(32).eval()
    if case == 'cpu_default_is_plain':
        model = _tiny_hrnet()
        img = torch.randn(2, 32, 32, 1)
        calls = _spy(monkeypatch, 'fused_cbam')
        with torch.no_grad():
            default = model(img)
        assert not calls
        monkeypatch.setattr(layers, 'FUSED_CBAM', False)
        with torch.no_grad():
            assert torch.equal(default, model(img))
    elif case in ('forced_on', 'forced_off'):
        monkeypatch.setattr(layers, 'FUSED_CBAM', case == 'forced_on')
        calls = _spy(monkeypatch, 'fused_cbam')
        with torch.no_grad():
            mod(x, res)
            mod(x)
        assert len(calls) == (2 if case == 'forced_on' else 0)
        # the rule says so on the card as well, whatever the input
        assert _rule(dtype=torch.float32, needs_grad=True, channels=48) \
            == (case == 'forced_on')
    elif case == 'training':
        mod.train()
        for forced in (None, True):
            monkeypatch.setattr(layers, 'FUSED_CBAM', forced)
            calls = _spy(monkeypatch, 'fused_cbam')
            mod(x, res).sum().backward()
            assert not calls
            assert _rule(training=True) is False
    elif case == 'needs_grad':
        # an eval-mode forward under autograd keeps its gradients
        rule = _spy(monkeypatch, 'takes_fused_cbam')
        calls = _spy(monkeypatch, 'fused_cbam')
        mod(x.requires_grad_(), res).sum().backward()
        assert x.grad is not None and not calls
        mod(x.detach(), res)            # the weights require grad
        with torch.no_grad():
            mod(x, res)
        assert [a[3] for a in rule] == [True, True, False]
        assert _rule(needs_grad=True) is False
    else:
        # the rule's own predicate on a CUDA bf16 eval input: K2 for the
        # kernel's channel counts, the plain chain for any other
        assert [_rule(channels=c) for c in (8, 32, 64, 256, 4096)] == \
            [True] * 5
        assert [_rule(channels=c) for c in (4, 48, 96, 8192)] == [False] * 4
        assert _rule(dtype=torch.float32) is False
        assert _rule(device='cpu') is False
        # the module hands the rule the input's device, dtype and grads
        rule = _spy(monkeypatch, 'takes_fused_cbam')
        with torch.no_grad():
            mod(x.to(torch.bfloat16), res.to(torch.bfloat16))
        assert rule[0] == (False, torch.device('cpu'), torch.bfloat16,
                           False, 32)


def _serving_cbam(dtype, channels_last):
    mod = layers.CBAM(64)
    torch.manual_seed(1)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3)
    if channels_last:
        mod = mod.to(memory_format=torch.channels_last)
    return mod.to(dtype).eval()


@pytest.mark.parametrize('dtype,channels_last', [(torch.bfloat16, True),
                                                 (torch.float32, False)])
def test_launch_reads_the_stored_weights_in_place(dtype, channels_last,
                                                  monkeypatch):
    """The wrapper hands the kernel the convs' own storage (their
    ``data_ptr``s, dtype code and the 7x7 conv's strides) and allocates
    only the output; the kernel's staging indices read the (7, 7, 2),
    (C, C/16) and (C/16, C) weights the plain version computes with; and
    the plain version fed the stored bf16 weights equals its f32-cast
    call."""
    from torch.utils._python_dispatch import TorchDispatchMode
    mod = _serving_cbam(dtype, channels_last)
    ca = mod.ChannelAttention_0
    fc1, fc2 = ca.Conv_0.weight, ca.Conv_1.weight
    spw = mod.SpatialAttention_0.Conv_0.weight
    x = torch.randn(2, 16, 16, 64).to(torch.bfloat16)
    res = torch.randn(2, 16, 16, 64).to(torch.bfloat16)
    launched = []

    def launch(*args):
        launched.append(args)
        return 0
    monkeypatch.setattr(cbam_fuse_mod, '_entry',
                        lambda name: {'cbam_fuse_launch': launch}[name])
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: type('S', (), {'cuda_stream': 7})())

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))
    with Ops() as ops:
        out = cbam_fuse_mod._launch(x, fc1, fc2, spw, res)
    assert ops.ops == ['aten.empty_like']
    (xp, rp, p1, p2, ps, sc, sy, sx, op, b, h, w, c, hid, code, ranks,
     stream), = launched
    assert (xp, rp, op) == (x.data_ptr(), res.data_ptr(), out.data_ptr())
    assert (p1, p2, ps) == (fc1.data_ptr(), fc2.data_ptr(), spw.data_ptr())
    assert code == cbam_fuse_mod._WEIGHT_DTYPES[dtype]
    assert (b, h, w, c, hid, ranks, stream) == (2, 16, 16, 64, 4, 0, 7)
    assert (sc, sy, sx) == ((1, 14, 2) if channels_last else (49, 7, 1))

    # the .cu's staging loops, on the storage as the kernel sees it
    def flat(t):
        return t.as_strided((t.numel(),), (1,)).float()
    s_w = torch.stack([flat(spw)[(i & 1) * sc + (i >> 1) // 7 * sy
                                 + (i >> 1) % 7 * sx] for i in range(98)])
    assert torch.equal(s_w, spw[0].float().permute(1, 2, 0).reshape(-1))
    assert torch.equal(flat(fc1), fc1.float()[:, :, 0, 0].reshape(-1))
    s_fc2 = flat(fc2).reshape(c, hid).t().reshape(-1)      # [j * C + c]
    assert torch.equal(s_fc2, fc2.float()[:, :, 0, 0].t().reshape(-1))

    want = cbam_plain(x, fc1.float(), fc2.float(), spw.float(), res)
    assert torch.equal(cbam_plain(x, fc1, fc2, spw, res), want)
