"""The port's ViTPose (``models/vitpose.py``) on the CPU in f32: against
the benchmark's plain reference (``h100_bench/reference/vitpose.py``) at a
tiny size on seeded weights, through ``infer_poses`` at the heatmaps'
stride of 4, the stride-1 path of every HRNet unchanged, the recorder's
stamps of a serving call, and the attention counter.

Tolerances: the port and the reference compute the same f32 products in
another order (flash SDPA against the written-out softmax, a channels-last
conv against the plain one), so heatmaps agree to 1e-5 of each frame's
largest magnitude (seen: ~2e-7); keypoints decoded from such maps agree
to 1e-3 px.  Poses: the reference's solve of the served keypoints,
confidences and maps agrees to 1e-5 (rotation, rad; relative translation;
the same f32 arithmetic); its own chain end to end to 1e-3, since seeded
maps put the keypoints where noise does and the PnP they pose is weakly
conditioned (seen: 1.9e-4 rad from keypoints ~1e-5 px apart)."""

import math

import pytest
import torch

from esa_pose_estimation_tpu_torch import pipeline
from esa_pose_estimation_tpu_torch.models import vitpose as pv
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.obs import profiling
from esa_pose_estimation_tpu_torch.ops import peak as peak_ops
from esa_pose_estimation_tpu_torch.ops import pnp as pnp_mod
from esa_pose_estimation_tpu_torch.utils import config as pcfg
from h100_bench import traffic
from h100_bench.reference import crop as rcrop
from h100_bench.reference import serve as rserve
from h100_bench.reference import vitpose as rv

SERVING = {'conf_threshold': 0.6, 'min_keypoints': 6, 'n_hypotheses': 16,
           'sample_size': 6, 'lm_iters': 10}


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ref_cfg(c: pcfg.ViTPoseConfig, final_std: float = 300.0) -> dict:
    """The reference's configuration dict of a port configuration."""
    return dict(crop_size=c.img_size, in_channels=1,
                patch_size=c.patch_size, patch_padding=c.patch_padding,
                embed_dim=c.embed_dim, depth=c.depth, num_heads=c.num_heads,
                mlp_ratio=c.mlp_ratio, ln_eps=c.ln_eps,
                head_channels=list(c.head_channels),
                num_keypoints=c.num_keypoints, head_final_std=final_std)


def models(c: pcfg.ViTPoseConfig, seed: int = 0):
    """The port's and the reference's model, eval, from one seeded state
    dict (``strict=True`` both)."""
    sd = rv.seeded_state_dict(ref_cfg(c), torch.Generator().manual_seed(seed))
    port = pv.ViTPose(c).eval()
    port.load_state_dict(sd, strict=True)
    ref = rv.ViTPose(ref_cfg(c)).eval()
    ref.load_state_dict(sd, strict=True)
    return port, ref


@pytest.fixture(scope='module')
def tiny():
    return models(pcfg.vitpose_tiny())


@pytest.fixture(scope='module')
def frames():
    """Three SPEED-like frames, their boxes and true keypoints (the
    benchmark's generator, on the CPU)."""
    tr = dict(height=1200, width=1920, min_depth_m=8.0, max_depth_m=20.0,
              box_margin_px=12.0, pool_frames=3)
    return traffic.frame_pool(5, tr, 8, torch.device('cpu'))


def _pose_gap(out, R, t) -> float:
    """The larger of the widest rotation gap (rad) and relative
    translation gap."""
    ang = 2 * torch.arcsin((out.R - R).flatten(1).norm(dim=-1)
                           / (2 * math.sqrt(2)))
    rel = (out.trans - t).norm(dim=-1) / t.norm(dim=-1)
    return max(float(ang.max()), float(rel.max()))


def _rel_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_forward_matches_reference(tiny):
    port, ref = tiny
    x = torch.randn(3, 64, 64, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        hm, hm_ref = port(x), ref(x)
    assert hm.shape == (3, 16, 16, 8) and hm.dtype == torch.float32
    assert hm.is_contiguous()
    assert _rel_gap(hm, hm_ref) < 1e-5


def test_published_widths_and_names():
    c = pcfg.vitpose_h_speed()
    assert (c.embed_dim, c.depth, c.num_heads, c.embed_dim // c.num_heads,
            c.embed_dim * c.mlp_ratio, c.head_channels) == (
        1280, 32, 16, 80, 5120, (256, 256))
    assert c.grid * 2 ** len(c.head_channels) == 128      # stride 4
    with torch.device('meta'):
        port = pv.ViTPose(c)
        keys = set(rv.ViTPose(ref_cfg(c)).state_dict())
    assert set(port.state_dict()) == keys
    for k in ('backbone.patch_embed.proj.weight', 'backbone.pos_embed',
              'backbone.blocks.31.attn.qkv.bias', 'backbone.last_norm.weight',
              'keypoint_head.deconv_layers.0.weight',
              'keypoint_head.deconv_layers.4.running_var',
              'keypoint_head.final_layer.bias'):
        assert k in keys, k
    assert sum(p.numel() for p in port.parameters()) == 638_277_150


def test_infer_poses_matches_reference_chain(tiny, frames):
    """Crop -> network -> decode at ``rates / stride`` -> solve, the
    reference's chain, against the port's ``infer_poses`` at stride 4."""
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
    # the reference's solve of the served keypoints, confidences and maps
    R, t = rserve.solve(pts, out.keypoints_2d, out.confidences,
                        out.heatmaps, r, origins, u, SERVING)
    assert _pose_gap(out, R, t) < 1e-5
    # the stride is in the uncrop: a heatmap pixel is 4 crop pixels
    coords, _ = peak_ops.decode_heatmaps_auto_nhwc(out.heatmaps)
    assert torch.allclose(out.keypoints_2d,
                          coords * 4 / rates[:, None, None]
                          + origins[:, None, :], atol=1e-3)


def _parent_tail(model, crops, rates, origins, pts, u, **kw):
    """The serving tail before heatmaps could be smaller than the crop:
    ``coords / rates + origins`` and the heatmap evidence at ``rates``."""
    K = pipeline.camera.speed_k(torch.float32, crops.device)
    x = pipeline.crop_ops.normalize(crops)[..., None]
    hm = model(x)
    coords, maxvals = peak_ops.decode_heatmaps_auto_nhwc(hm)
    sel = peak_ops.select_confident(maxvals, kw['conf_threshold'],
                                    min_count=kw['min_keypoints'])
    uncropped = (coords / rates[:, None, None]
                 + origins[:, None, :].to(torch.float32))
    p3 = pts.expand((crops.shape[0],) + pts.shape)
    init = pnp_mod.ransac_epnp(p3, uncropped, K, None, valid=sel,
                               n_hypotheses=kw['n_hypotheses'],
                               sample_size=kw['sample_size'],
                               lm_iters=kw['lm_iters'], uniforms=u)
    keep = init.inliers & sel
    keep = torch.where((keep.sum(-1) >= 4)[..., None], keep, sel)
    w = torch.where(keep, maxvals, 0.0)
    ev = pnp_mod.heatmap_evidence(hm.to(torch.float32), p3, K, rates,
                                  origins, valid=sel)
    R, t = pnp_mod.lm_refine_dual(p3, uncropped, w, K, init.R, init.t,
                                  iters=kw['lm_iters'], evidence_fn=ev)
    return uncropped, R, t


def test_stride_one_is_bit_identical(frames):
    """``hrnet_tiny`` (heatmaps at the crop's size): the served keypoints
    and poses ``torch.equal`` to the tail before the stride."""
    model = HRNet(pcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0)).eval()
    crops, rates, origins = rcrop.crop_resize(
        frames.frames, frames.boxes, 32, img_w=1920, img_h=1200,
        force_square=True)
    pts = traffic.points_3d(6, torch.device('cpu'))
    u = torch.rand((3, 16, 6), generator=torch.Generator().manual_seed(3))
    kw = dict(SERVING, min_keypoints=4)
    out = pipeline.infer_poses_from_crops(model, crops, rates, origins, pts,
                                          ransac_uniforms=u, **kw)
    with torch.no_grad():
        kp, R, t = _parent_tail(model, crops, rates, origins, pts, u, **kw)
    assert out.heatmaps.shape[1] == crops.shape[1]
    assert torch.equal(out.keypoints_2d, kp)
    assert torch.equal(out.R, R) and torch.equal(out.trans, t)


def test_stride_must_tile_the_crop():
    with pytest.raises(ValueError, match='whole stride'):
        pipeline._heatmap_stride(torch.zeros(1, 64, 64),
                                 torch.zeros(1, 24, 24, 3))


def test_serving_call_stamps_fit_the_ring(frames):
    """A serving call of a 32-block ViTPose (ViTPose-H's depth, tiny
    widths) keeps every stage's stamps: 2 for the call, 2 for each of
    crop, hrnet, vit_encoder, vit_head, decode, ransac_epnp and refine, 2
    for each block's attention; 80, within the ring's stride."""
    c = pcfg.ViTPoseConfig(num_keypoints=8, img_size=64, embed_dim=16,
                           depth=32, num_heads=2, head_channels=(8, 8))
    port, _ = models(c)
    serve = pipeline.make_jitted_pipeline(
        port, traffic.points_3d(8, torch.device('cpu')), crop_size=64,
        **SERVING)
    u = torch.rand((3, SERVING['n_hypotheses'], 8))
    rec = profiling.recorder()
    before = rec.seq
    serve(frames.frames, frames.boxes, ransac_uniforms=u)
    assert rec.seq == before + 1
    call = rec.calls()[-1]
    assert len(call.stamps) == 80 <= profiling.RING_STAMPS - 32
    ns = profiling.stage_ns(call)
    assert len(ns['attention']) == 32
    for name in ('crop', 'hrnet', 'vit_encoder', 'vit_head', 'decode',
                 'ransac_epnp', 'refine'):
        assert len(ns[name]) == 1, name


def test_attention_counter_per_forward(tiny):
    port, _ = tiny
    calls, tokens = pv.attention.launches, pv.attention.tokens
    with torch.no_grad():
        port(torch.zeros(5, 64, 64, 1))
    assert pv.attention.launches - calls == 2           # one a block
    assert pv.attention.tokens - tokens == 2 * 5 * 16   # 4x4 tokens a frame
