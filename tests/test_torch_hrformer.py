"""The port's HRFormer (``models/hrformer.py``) on the CPU in f32: against
the benchmark's plain reference (``h100_bench/reference/hrformer.py``) at
tiny sizes on seeded weights, its window padding and relative-position
index, through ``infer_poses`` at the heatmaps' stride of 4, the
recorder's stamps and the attention counter of a serving call at
HRFormer-B's depth, and the HRNet skeleton it shares (``models/hrnet.py``)
and ViTPose's attention wrapper left as they were.

Tolerances: the port and the reference compute the same f32 products in
another order (the SDPA kernel against the written-out softmax, head dims
padded with zeros, channels-last convs against plain ones), so heatmaps
agree to 1e-5 of each frame's largest magnitude (seen: ~6e-7); keypoints
decoded from such maps to 1e-3 px; confidences to 1e-5 relative.  Poses:
the reference's solve of the served keypoints, confidences and maps
agrees to 1e-5 (the same f32 arithmetic); its own chain end to end to
1e-3, since seeded maps put keypoints where noise does and the PnP they
pose is weakly conditioned.  What is unchanged is held bit for bit to
outputs the code wrote before HRFormer was added
(``tests/fixtures/forward_before_hrformer.npz``)."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu_torch import pipeline
from esa_pose_estimation_tpu_torch.models import hrformer as ph
from esa_pose_estimation_tpu_torch.models import vitpose as pv
from esa_pose_estimation_tpu_torch.models.hrnet import FuseLayer, HRNet
from esa_pose_estimation_tpu_torch.models.layers import (
    CBAM,
    ConvBN,
    SeparableConvBN,
    resize_bilinear,
)
from esa_pose_estimation_tpu_torch.obs import profiling
from esa_pose_estimation_tpu_torch.ops import peak as peak_ops
from esa_pose_estimation_tpu_torch.utils import config as pcfg
from h100_bench import traffic
from h100_bench.reference import crop as rcrop
from h100_bench.reference import hrformer as rh
from h100_bench.reference import serve as rserve
from h100_bench.reference import vitpose as rv

SERVING = {'conf_threshold': 0.6, 'min_keypoints': 6, 'n_hypotheses': 16,
           'sample_size': 6, 'lm_iters': 10}
BEFORE = 'tests/fixtures/forward_before_hrformer.npz'


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_cfg(c: pcfg.HRFormerConfig, final_std: float = 0.03) -> dict:
    """The reference's configuration dict of a port configuration (every
    stage's blocks a branch, window and MLP ratio alike)."""
    s2, s3, s4 = c.stage2, c.stage3, c.stage4
    return dict(crop_size=c.img_size, in_channels=1,
                num_keypoints=c.num_keypoints, stem_channels=c.stem_channels,
                stage1_blocks=c.stage1.num_blocks[0],
                stage1_planes=c.stage1.num_channels[0],
                channels=list(s4.num_channels), heads=list(s4.num_heads),
                modules=[s2.num_modules, s3.num_modules, s4.num_modules],
                blocks_per_branch=s4.num_blocks[0], window=s4.window_size,
                mlp_ratio=s4.mlp_ratio, head_final_std=final_std)


def models(c: pcfg.HRFormerConfig, seed: int = 0):
    """The port's and the reference's model, eval, from one seeded state
    dict (``strict=True`` both)."""
    sd = rh.seeded_state_dict(ref_cfg(c), torch.Generator().manual_seed(seed))
    port = ph.HRFormer(c).eval()
    port.load_state_dict(sd, strict=True)
    ref = rh.HRFormer(ref_cfg(c)).eval()
    ref.load_state_dict(sd, strict=True)
    return port, ref


def b_depth(size: int = 32) -> pcfg.HRFormerConfig:
    """HRFormer-B's depth (1, 4, 2 modules of 2 blocks a branch: 44
    blocks, 7 fusions) at tiny widths, heads of 39 kept."""
    st = lambda m, n: pcfg.HRFormerStageConfig(   # noqa: E731
        m, n, (2,) * n, (39, 78, 117, 156)[:n], num_heads=(1, 2, 3, 4)[:n],
        mlp_ratio=1)
    return pcfg.HRFormerConfig(
        num_keypoints=8, img_size=size, stem_channels=8,
        stage1=pcfg.StageConfig(1, 1, (1,), (8,), 'BOTTLENECK'),
        stage2=st(1, 2), stage3=st(4, 3), stage4=st(2, 4))


@pytest.fixture(scope='module')
def tiny():
    return models(pcfg.hrformer_tiny())


@pytest.fixture(scope='module')
def frames():
    """Three SPEED-like frames, their boxes and true keypoints (the
    benchmark's generator, on the CPU)."""
    tr = dict(height=1200, width=1920, min_depth_m=8.0, max_depth_m=20.0,
              box_margin_px=12.0, pool_frames=3)
    return traffic.frame_pool(5, tr, 8, torch.device('cpu'))


def _rel_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _pose_gap(out, R, t) -> float:
    ang = 2 * torch.arcsin((out.R - R).flatten(1).norm(dim=-1)
                           / (2 * math.sqrt(2)))
    rel = (out.trans - t).norm(dim=-1) / t.norm(dim=-1)
    return max(float(ang.max()), float(rel.max()))


@pytest.mark.parametrize('size', [64, 96])
def test_forward_matches_reference(tiny, size):
    """At 64 the branches are 16, 8, 4, 2 a side (padded to 21, 14, 7, 7),
    at 96 they are 24, 12, 6, 3 (28, 14, 7, 7)."""
    port, ref = tiny
    x = torch.randn(3, size, size, 1,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        hm, hm_ref = port(x), ref(x)
    assert hm.shape == (3, size // 4, size // 4, 8)
    assert hm.dtype == torch.float32 and hm.is_contiguous()
    assert _rel_gap(hm, hm_ref) < 1e-5


def test_published_widths_and_names():
    c = pcfg.hrformer_b_speed()
    st = c.stages
    assert [s.num_modules for s in st[1:]] == [1, 4, 2]
    assert st[3].num_channels == (78, 156, 312, 624)
    assert [ch // h for ch, h in zip(st[3].num_channels,
                                     st[3].num_heads)] == [39] * 4
    assert (st[3].window_size, st[3].mlp_ratio) == (7, 4)
    assert sum(s.num_modules * sum(s.num_blocks) for s in st[1:]) == 44
    assert st[0].num_blocks == (2,)
    with torch.device('meta'):
        port = ph.HRFormer(c)
        keys = set(rh.HRFormer(ref_cfg(c)).state_dict())
    assert set(port.state_dict()) == keys
    for k in ('ConvBN_1.Conv_0.weight',
              'BranchBlocks_0.Bottleneck_1.ConvBN_2.Conv_0.weight',
              'Transition_2.ConvBN_0.Conv_0.weight',
              'HRModule_6.BranchBlocks_3.HRFormerBlock_1.attn.'
              'relative_position_bias_table',
              'HRModule_6.BranchBlocks_0.HRFormerBlock_0.ffn.dw3x3.weight',
              'HRModule_5.FuseLayer_0.SeparableConvBN_5.Conv_1.weight',
              'final_layer.bias'):
        assert k in keys, k
    # the last module fuses into branch 0 alone: 3 upsampling convs
    last = port.HRModule_6.FuseLayer_0
    assert len(last.paths) == 1 and len(list(last.children())) == 3
    assert sum(p.numel() for p in port.parameters()) == 43_212_804
    assert not any(isinstance(m, CBAM) for m in port.modules())


def test_relative_position_index_hand_built():
    """A 2x2 window, tokens (0,0), (0,1), (1,0), (1,1): the index is
    (dy + 1) * 3 + (dx + 1)."""
    hand = torch.tensor([[4, 3, 1, 0],
                         [5, 4, 2, 1],
                         [7, 6, 4, 3],
                         [8, 7, 5, 4]])
    assert torch.equal(ph.relative_position_index(2), hand)
    assert torch.equal(rh.relative_position_index(2), hand)
    idx = ph.relative_position_index(7)
    assert torch.equal(idx, rh.relative_position_index(7))
    assert idx.shape == (49, 49) and int(idx.max()) == 168
    assert int(idx[0, 48]) == 0 and int(idx[48, 0]) == 168
    assert torch.equal(idx.diagonal(), torch.full((49,), 84))


@pytest.mark.parametrize('h, w, expect', [(16, 16, (2, 3, 2, 3)),
                                          (8, 7, (3, 3, 0, 0)),
                                          (14, 3, (0, 0, 2, 2))])
def test_window_pad_centres(h, w, expect):
    assert ph.window_pad(h, w, 7) == expect


def test_pad_tokens_take_part_unmasked():
    """An 8x8 map in 7x7 windows: 3 zero rows and columns before, 3 after,
    four windows.  The port's output is each window's written-out softmax
    over all 49 tokens, the padded zeros among them; masking the padded
    keys instead gives another answer."""
    torch.manual_seed(0)
    att = ph.WindowAttention(39, 1, 7).eval()
    with torch.no_grad():
        att.relative_position_bias_table.normal_(0.0, 0.5)
        x = torch.randn(1, 8, 8, 39)
        out = att(x)
        xp = F.pad(x, (0, 0, 3, 3, 3, 3))        # (1, 14, 14, 39)
        bias = att.relative_position_bias_table[
            att.relative_position_index.reshape(-1)].reshape(49, 49)
        full = torch.zeros(1, 14, 14, 39)
        masked = torch.zeros(1, 14, 14, 39)
        pad = torch.ones(14, 14, dtype=torch.bool)
        pad[3:11, 3:11] = False
        for wy in range(2):
            for wx in range(2):
                sl = (slice(7 * wy, 7 * wy + 7), slice(7 * wx, 7 * wx + 7))
                tok = xp[0][sl].reshape(49, 39)
                q, k, v = att.qkv(tok).split(39, dim=-1)
                logits = q @ k.T * 39 ** -0.5 + bias
                o = torch.softmax(logits, -1) @ v
                full[0][sl] = att.proj(o).reshape(7, 7, 39)
                keep = ~pad[sl].reshape(49)
                om = torch.softmax(logits.masked_fill(~keep, -math.inf),
                                   -1) @ v
                masked[0][sl] = att.proj(om).reshape(7, 7, 39)
    assert torch.allclose(out, full[:, 3:11, 3:11], atol=1e-5)
    assert not torch.allclose(out, masked[:, 3:11, 3:11], atol=1e-3)


def test_infer_poses_matches_reference_chain(tiny, frames):
    """Crop -> network -> decode at ``rates / 4`` -> solve, the
    reference's chain, against the port's ``infer_poses``."""
    port, ref = tiny
    u = torch.rand((3, SERVING['n_hypotheses'], 8),
                   generator=torch.Generator().manual_seed(2))
    pts = traffic.points_3d(8, torch.device('cpu'))
    out = pipeline.infer_poses(port, frames.frames, frames.boxes, pts,
                               crop_size=64, ransac_uniforms=u, **SERVING)
    crops, rates, origins = rcrop.crop_resize(
        frames.frames, frames.boxes, 64, img_w=1920, img_h=1200,
        force_square=True)
    with torch.no_grad():
        hm = ref(rcrop.normalize(crops)[..., None])
    r = rates / 4
    kp, conf = rserve.decode(hm, r, origins)
    R, t = rserve.solve(pts, kp, conf, hm, r, origins, u, SERVING)
    assert out.heatmaps.shape == (3, 16, 16, 8)
    assert _rel_gap(out.heatmaps, hm) < 1e-5
    assert float((out.keypoints_2d - kp).abs().max()) < 1e-3
    assert torch.allclose(out.confidences, conf, rtol=1e-5, atol=1e-6)
    assert _pose_gap(out, R, t) < 1e-3
    R, t = rserve.solve(pts, out.keypoints_2d, out.confidences,
                        out.heatmaps, r, origins, u, SERVING)
    assert _pose_gap(out, R, t) < 1e-5
    coords, _ = peak_ops.decode_heatmaps_auto_nhwc(out.heatmaps)
    assert torch.allclose(out.keypoints_2d,
                          coords * 4 / rates[:, None, None]
                          + origins[:, None, :], atol=1e-3)


@pytest.fixture(scope='module')
def deep():
    return models(b_depth())[0]


def test_serving_call_stamps_fit_the_ring(deep, frames):
    """A serving call at HRFormer-B's depth keeps every stage's stamps: 2
    for the call, 2 for each of crop, hrnet, decode, ransac_epnp and
    refine, 2 for each of the 44 blocks' attention cores and of the 7
    fusions; 114, within the ring's 128."""
    serve = pipeline.make_jitted_pipeline(
        deep, traffic.points_3d(8, torch.device('cpu')), crop_size=32,
        **SERVING)
    u = torch.rand((3, SERVING['n_hypotheses'], 8))
    rec = profiling.recorder()
    before = rec.seq
    serve(frames.frames, frames.boxes, ransac_uniforms=u)
    assert rec.seq == before + 1
    call = rec.calls()[-1]
    assert len(call.stamps) == 114 <= profiling.RING_STAMPS
    ns = profiling.stage_ns(call)
    assert len(ns['attention']) == 44 and len(ns['fuse']) == 7
    for name in ('crop', 'hrnet', 'decode', 'ransac_epnp', 'refine'):
        assert len(ns[name]) == 1, name


@pytest.mark.parametrize('which', ['tiny', 'b_depth'])
def test_attention_counter_per_forward(which, tiny, deep):
    """One call a block; query tokens: each branch's padded side squared,
    per block and frame (tiny at 64: 21, 14, 7, 7; B's depth at 32:
    branches of 8, 4, 2, 1 padded to 14, 7, 7, 7)."""
    model, size, blocks, sides = {
        'tiny': (tiny[0], 64, [3, 3, 2, 1], [21, 14, 7, 7]),
        'b_depth': (deep, 32, [14, 14, 12, 4], [14, 7, 7, 7])}[which]
    calls, tokens = pv.attention.launches, pv.attention.tokens
    with torch.no_grad():
        model(torch.zeros(5, size, size, 1))
    assert pv.attention.launches - calls == sum(blocks)
    assert pv.attention.tokens - tokens == 5 * sum(
        b * s * s for b, s in zip(blocks, sides))


def test_backends_pinned_by_name():
    """ViTPose keeps flash; HRFormer names its own per device, and the
    wrapper raises where its pinned backend cannot take an input (here,
    the card's memory-efficient kernel on CPU tensors)."""
    from torch.nn.attention import SDPBackend
    assert pv.SDPA_BACKEND == SDPBackend.FLASH_ATTENTION
    assert ph.SDPA_BACKENDS == {'cuda': SDPBackend.EFFICIENT_ATTENTION,
                                'cpu': SDPBackend.FLASH_ATTENTION}
    q = torch.randn(2, 1, 49, 40)
    with pytest.raises(RuntimeError):
        pv.attention(q, q, q, 0.16, SDPBackend.EFFICIENT_ATTENTION)


def test_head_padding_is_exact():
    """Heads of 39 padded with a zero column to 40 at scale 39 ** -0.5:
    the same attention as unpadded."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 2, 49, 39, generator=g) for _ in range(3))
    bias = torch.randn(1, 2, 49, 49, generator=g)
    plain = torch.softmax(q @ k.transpose(-2, -1) * 39 ** -0.5 + bias,
                          -1) @ v
    pad = [F.pad(t, (0, 1)) for t in (q, k, v)]
    out = pv.attention(*pad, 39 ** -0.5, ph.SDPA_BACKENDS['cpu'],
                       bias=bias)
    assert torch.allclose(out[..., :39], plain, atol=1e-5)
    assert torch.equal(out[..., 39], torch.zeros_like(out[..., 39]))


def test_hrnet_tiny_forward_unchanged():
    """``hrnet_tiny`` (the HRNet skeleton HRFormer now shares: its blocks,
    modules, transitions and conv fusion) in eval and train mode, bit for
    bit as before."""
    before = np.load(BEFORE)
    m = HRNet(pcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(m(x), torch.from_numpy(before['hrnet_tiny_eval']))
    m.train()
    assert torch.equal(m(x).detach(),
                       torch.from_numpy(before['hrnet_tiny_train']))


def test_vitpose_tiny_forward_unchanged():
    """ViTPose through the wrapper with its backend passed per call, bit
    for bit as before."""
    before = np.load(BEFORE)
    c = pcfg.vitpose_tiny()
    cfg = dict(crop_size=c.img_size, in_channels=1,
               patch_size=c.patch_size, patch_padding=c.patch_padding,
               embed_dim=c.embed_dim, depth=c.depth, num_heads=c.num_heads,
               mlp_ratio=c.mlp_ratio, ln_eps=c.ln_eps,
               head_channels=list(c.head_channels),
               num_keypoints=c.num_keypoints, head_final_std=300.0)
    v = pv.ViTPose(c).eval()
    v.load_state_dict(rv.seeded_state_dict(
        cfg, torch.Generator().manual_seed(0)), strict=True)
    x = torch.randn(3, 64, 64, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(v(x), torch.from_numpy(before['vitpose_tiny']))


def test_fuse_layer_conv_path_unchanged():
    """The conv fusion's modules keep their names and order, and its
    output is the sum of its paths as the fusion always took it."""
    torch.manual_seed(0)
    chans = (8, 16, 32)
    fuse = FuseLayer(3, chans).eval()
    assert [n for n, _ in fuse.named_children()] == [
        f'ConvBN_{i}' for i in range(7)]
    assert all(isinstance(m, ConvBN) for m in fuse.children())
    xs = [torch.randn(2, c, 16 // 2 ** i, 16 // 2 ** i)
          for i, c in enumerate(chans)]
    with torch.no_grad():
        out = fuse(xs)
        f = lambda i: getattr(fuse, f'ConvBN_{i}')    # noqa: E731
        up = lambda y, i: resize_bilinear(           # noqa: E731
            y, tuple(xs[i].shape[2:4]))
        expect = [xs[0] + up(f(0)(xs[1]), 0) + up(f(1)(xs[2]), 0),
                  f(2)(xs[0]) + xs[1] + up(f(3)(xs[2]), 1),
                  f(5)(f(4)(xs[0])) + f(6)(xs[1]) + xs[2]]
    for o, e in zip(out, expect):
        assert torch.equal(o, torch.relu(e))


def test_fuse_layer_separable_path():
    """HRFormer's fusion: j < i goes through depthwise-separable steps
    (ReLU between, none on the last), j > i through a 1x1 conv and the
    bilinear upsample; only the first ``outputs`` branches come out."""
    chans = (8, 16, 32)
    fuse = FuseLayer(3, chans, separable=True).eval()
    names = [n for n, _ in fuse.named_children()]
    assert names == ['ConvBN_0', 'ConvBN_1', 'SeparableConvBN_0',
                     'ConvBN_2', 'SeparableConvBN_1', 'SeparableConvBN_2',
                     'SeparableConvBN_3']
    s = fuse.SeparableConvBN_1
    assert (s.Conv_0.groups, s.Conv_0.stride, s.relu) == (8, (2, 2), True)
    assert fuse.SeparableConvBN_2.relu is False
    assert fuse.SeparableConvBN_2.Conv_1.out_channels == 32
    torch.manual_seed(0)
    xs = [torch.randn(2, c, 16 // 2 ** i, 16 // 2 ** i)
          for i, c in enumerate(chans)]
    with torch.no_grad():
        out = fuse(xs)
        expect = (fuse.SeparableConvBN_2(fuse.SeparableConvBN_1(xs[0]))
                  + fuse.SeparableConvBN_3(xs[1]) + xs[2])
    assert torch.equal(out[2], torch.relu(expect))
    one = FuseLayer(3, chans, separable=True, outputs=1)
    assert [n for n, _ in one.named_children()] == ['ConvBN_0', 'ConvBN_1']
    assert len(one.eval()(xs)) == 1
    assert isinstance(fuse.SeparableConvBN_0, SeparableConvBN)
