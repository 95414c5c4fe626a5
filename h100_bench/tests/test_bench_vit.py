"""The ViTPose cell (``vitpose_h_offline_b64``): its configuration against
the port's ``vitpose_h_speed``, the frozen FLOP counts against
``vit_counts.py`` and a hand count from the published equations, its
readers on synthetic records, and at ``vitpose_tiny`` size on the CPU the
cell's run (``drivers/serve_vit.py``): sound, it is correct; with a fault
planted in the timed path (attention's scale left out, one block skipped,
the stride ignored in the uncrop, the served rotation turned), it is
not."""

import functools
import statistics
from types import SimpleNamespace

import pytest
import torch

from h100_bench import harness, run, vit_counts
from h100_bench.drivers import serve_vit
from h100_bench.tests import _tiny_vit

CELL = _tiny_vit.CELL
CFG = harness.config('vitpose_h_serve')
NEW = ['vit_encoder_ms', 'vit_attention_ms', 'vit_head_ms',
       'vit_attention_roofline', 'vit_crop_ms', 'vit_decode_ms',
       'vit_solver_ms', 'vit_idle_pct', 'vit_serve_mfu', 'vit_k1_roofline']
SPANS = NEW[:8]
MS = 1_000_000


def hand_forward(c: dict) -> int:
    """From the equations: the patch conv; per block the linears (qkv 3D,
    proj D, fc1 and fc2 4D each: 24 N D^2) and both attention products
    (4 N^2 D); the deconvs (2 Cin Cout k^2 on the input's pixels) and the
    final 1x1 conv; 2 per multiply-add."""
    g = (c['crop_size'] + 2 * c['patch_padding']
         - c['patch_size']) // c['patch_size'] + 1
    n, d = g * g, c['embed_dim']
    out = 2 * n * d * 3 * c['patch_size'] ** 2
    out += c['depth'] * (2 * n * d * d * (3 + 1 + 2 * c['mlp_ratio'])
                         + 4 * n * n * d)
    cin, side = d, g
    for ch in c['head_channels']:
        out += 2 * cin * ch * 4 * 4 * side * side
        cin, side = ch, side * 2
    return out + 2 * cin * c['num_keypoints'] * side * side


def test_config_is_the_ports_vitpose_h():
    from esa_pose_estimation_tpu_torch.utils.config import vitpose_h_speed
    assert serve_vit.port_config(CFG) == vitpose_h_speed()
    assert CFG['embed_dim'] // CFG['num_heads'] == CFG['head_dim'] == 80
    assert CFG['heatmap_size'] * 4 == CFG['crop_size']
    from h100_bench.reference import vitpose
    assert vitpose.stride(CFG) == 4
    with torch.device('meta'):
        ref = vitpose.ViTPose(CFG)
    assert sum(p.numel() for p in ref.parameters()) == CFG['parameters']


@pytest.mark.parametrize('cfg', [CFG, {**CFG, **_tiny_vit.TINY}],
                         ids=['vitpose_h', 'tiny'])
def test_forward_flops_against_hand_count(cfg):
    assert vit_counts.forward_flops(cfg) == hand_forward(cfg)
    assert vit_counts.forward_flops(cfg, batch=3) == 3 * hand_forward(cfg)


def test_frozen_flops():
    assert CFG['flops_forward_per_image'] == vit_counts.forward_flops(CFG)
    assert CFG['flops_forward_per_image'] == 1_481_881_157_632
    n, d = 32 * 32, 1280
    assert CFG['flops_attention_per_image'] == \
        vit_counts.attention_flops(CFG) == 32 * 4 * n * n * d


class _Fake:
    def __init__(self, calls):
        self._calls = calls

    def calls(self):
        return list(self._calls)


def _record(index, start, blocks, att_ms, enc_ms, head_ms):
    """A serving call: crop, then hrnet holding vit_encoder (its own
    ``enc_ms`` around ``blocks`` attention stages of ``att_ms``) and
    vit_head, then decode, ransac_epnp and refine."""
    from esa_pose_estimation_tpu_torch.obs.profiling import CallRecord
    t = start * MS
    stamps = [('call', t)]

    def span(name, ms):
        nonlocal t
        stamps.append((name, t))
        t += round(ms * MS)
        stamps.append(('/' + name, t))

    span('crop', 1)
    stamps.append(('hrnet', t))
    stamps.append(('vit_encoder', t))
    for _ in range(blocks):
        t += round(enc_ms / blocks * MS)
        span('attention', att_ms)
    stamps.append(('/vit_encoder', t))
    span('vit_head', head_ms)
    stamps.append(('/hrnet', t))
    for name in ('decode', 'ransac_epnp', 'refine'):
        span(name, 0.5)
    stamps.append(('/call', t))
    host = tuple(start * MS - 10_000 + k * 100 for k in range(5))
    return CallRecord(index, 3, index, 'cuda:0', host, tuple(stamps))


def _calls(n):
    return [_record(i, 300 * i, 4, 1 + 0.1 * (i % 3), 100 + i % 3, 2)
            for i in range(n)]


def _rec(n_window, rate=300.0):
    return SimpleNamespace(workload=harness.workload(CELL), config=CFG,
                           host_call_s=[0.001] * n_window, chips=1,
                           window_images_per_s=rate)


def test_readers_on_synthetic_records(monkeypatch):
    from esa_pose_estimation_tpu_torch.obs import profiling
    tr = harness.workload(CELL)['traffic']
    head, tail = tr['warm_up_calls'] + 1, tr['trace_calls'] + 1
    calls = _calls(head + 3 + tail)
    monkeypatch.setattr(profiling, '_RECORDER', _Fake(calls))
    win = calls[head:head + 3]
    assert [c.index % 3 for c in win] == [0, 1, 2]
    att = statistics.median(4 * (1 + 0.1 * (c.index % 3)) for c in win)
    enc = statistics.median(100 + c.index % 3 for c in win) + att
    busy = sum(c.stamps[-1][1] - c.stamps[0][1] for c in win)
    span = win[-1].stamps[-1][1] - win[0].stamps[0][1]
    expect = {'vit_attention_ms': att, 'vit_encoder_ms': enc,
              'vit_head_ms': 2.0,
              'vit_attention_roofline': 100 * 64 * CFG[
                  'flops_attention_per_image'] / 989e12 / (att * 1e-3),
              'vit_crop_ms': 1.0, 'vit_decode_ms': 0.5, 'vit_solver_ms': 1.0,
              'vit_idle_pct': 100 * (1 - busy / span),
              'vit_serve_mfu': 100 * 300 * CFG['flops_forward_per_image']
              / 989e12}
    rec = _rec(3)
    for name in NEW[:-1]:
        assert harness.reader(name)(rec) == pytest.approx(expect[name]), name
    # a window the harness counts otherwise, and no records: nothing
    for name in SPANS:
        assert harness.reader(name)(_rec(4)) is None
    monkeypatch.setattr(profiling, '_RECORDER', _Fake([]))
    for name in SPANS:
        assert harness.reader(name)(rec) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, 'recorder')
    for name in SPANS:
        assert harness.reader(name)(rec) is None


def test_k1_roofline_reads_the_heatmaps_size():
    """K1 reads (64, 128, 128, 30) f32 heatmaps a call, not crops."""
    kernel = SimpleNamespace(start=0.0, end=40.0)            # µs
    rec = SimpleNamespace(
        config=CFG, calls=2, images=128,
        trace=SimpleNamespace(kernels=lambda name: (
            [kernel, kernel] if name == 'peak_decode_kernel' else [])))
    read = harness.reader('vit_k1_roofline')
    bound = (64 * 128 * 128 * 30 * 4 + 64 * 30 * 3 * 4) / 3.35e12
    assert read(rec) == pytest.approx(100 * bound / 40e-6)
    rec.trace = SimpleNamespace(kernels=lambda name: [])
    assert read(rec) is None


def test_sound_run_is_correct():
    out = run.run_cell(_tiny_vit.context())
    assert out['correct'], out['judged']
    assert out['attempted'] > 0 and out['failed'] == 0
    assert set(out['metrics']) == set(harness.workload(CELL)['end_to_end'])
    # the end-to-end pose is read, not judged
    assert 'rotation_gap_p99_rad' in out['numbers']
    assert 'rotation_gap_p99_rad' not in out['judged']


def test_traced_run_reports_the_readers(monkeypatch):
    """Every reader reads the tiny traced run, but K1's roofline, which
    reads the card's kernels (none on the CPU) and leaves the line."""
    torch.manual_seed(0)
    ctx = _tiny_vit.context()
    ctx.trace = True
    ctx.per_layer[:] = [m for m in harness.benchmark()['per_layer']
                        if m['name'] in NEW]
    out = run.run_cell(ctx)
    assert out['correct'], out['judged']
    assert sorted(out['layer']) == sorted(set(NEW) - {'vit_k1_roofline'})
    assert all(v['value'] >= 0 for k, v in out['layer'].items()
               if k == 'vit_idle_pct')
    assert all(v['value'] > 0 for k, v in out['layer'].items()
               if k != 'vit_idle_pct')


def _altered_model(monkeypatch, alter):
    """``serve_vit.program_model`` altered by ``alter(model)``."""
    plain = serve_vit.program_model

    def altered(*args, **kwargs):
        model = plain(*args, **kwargs)
        alter(model)
        return model
    monkeypatch.setattr(serve_vit, 'program_model', altered)


def _no_scale(monkeypatch):
    def alter(model):
        for blk in model.backbone.blocks:
            blk.attn.scale = 1.0
    _altered_model(monkeypatch, alter)


def _skip_block(monkeypatch):
    def alter(model):
        del model.backbone.blocks[1]
    _altered_model(monkeypatch, alter)


def _pose_altered(monkeypatch):
    """Every served rotation turned by 1e-3 rad where it is produced."""
    from esa_pose_estimation_tpu_torch import pipeline
    plain = pipeline.infer_poses
    c, s = torch.cos(torch.tensor(1e-3)), torch.sin(torch.tensor(1e-3))
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    @functools.wraps(plain)
    def infer(*args, **kwargs):
        out = plain(*args, **kwargs)
        return out._replace(R=out.R @ rot)
    monkeypatch.setattr(pipeline, 'infer_poses', infer)


def _no_stride(monkeypatch):
    from esa_pose_estimation_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, '_heatmap_stride', lambda crops, hm: 1)


def _half_unsolved(monkeypatch):
    """The second half of each call's poses left as an unsolved slot
    holds them (identity, zero translation)."""
    from esa_pose_estimation_tpu_torch import pipeline
    plain = pipeline.infer_poses

    @functools.wraps(plain)
    def infer(*args, **kwargs):
        out = plain(*args, **kwargs)
        half = torch.arange(out.R.shape[0]) >= out.R.shape[0] // 2
        return out._replace(
            R=torch.where(half[:, None, None], torch.eye(3), out.R),
            trans=torch.where(half[:, None], 0.0, out.trans))
    monkeypatch.setattr(pipeline, 'infer_poses', infer)


def _quarter_swapped(monkeypatch):
    """The last quarter of each call's poses written from the frame
    before them."""
    from esa_pose_estimation_tpu_torch import pipeline
    plain = pipeline.infer_poses

    @functools.wraps(plain)
    def infer(*args, **kwargs):
        out = plain(*args, **kwargs)
        n = out.R.shape[0]
        src = torch.arange(n)
        src[n - n // 4:] -= 1
        return out._replace(R=out.R[src], trans=out.trans[src])
    monkeypatch.setattr(pipeline, 'infer_poses', infer)


@pytest.mark.parametrize('fault', [_no_scale, _skip_block, _no_stride,
                                   _pose_altered, _half_unsolved,
                                   _quarter_swapped],
                         ids=['attention_scale', 'block_skipped',
                              'stride_ignored', 'pose_altered',
                              'half_unsolved', 'quarter_swapped'])
def test_planted_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    out = run.run_cell(_tiny_vit.context())
    assert not out['correct'], out['judged']


@pytest.mark.card
def test_control_fails_on_the_card(card):
    """The fp8 control at the cell's size fails a limit."""
    from h100_bench import check
    wl = harness.workload(CELL)
    s = serve_vit.ServeViT(run.make_context(CELL, 2**31 + 11, 2.0, False,
                                            'cuda'))
    s.setup()
    harness.Window(2.0).run(s.call)
    s.free_program()
    judged = check.judge(s.numbers(control=True), wl['limits'])
    assert not all(v['ok'] for v in judged.values()), judged

