"""The HRFormer cell (``hrformer_b_offline_b64``) and the host-ingest cell
(``serve_offline_host_b256``): the configuration against the port's
``hrformer_b_speed``, the frozen FLOP and byte counts against
``hrf_counts.py`` and a hand count from the published equations, the new
cells' files and names, their readers on synthetic records, and on the
CPU at tiny size each cell's run (``drivers/serve_hrformer.py``,
``drivers/serve_host.py``): sound, it is correct; with the timed path
broken (half of each call's poses left unsolved, a quarter of them
another frame's, an HRFormer block skipped), it is not."""

import statistics
from types import SimpleNamespace

import pytest
import torch

from h100_bench import harness, hrf_counts, run
from h100_bench.drivers import serve_hrformer
from h100_bench.reference import hrformer as ref_hrf
from h100_bench.tests import _tiny, _tiny_hrf
from h100_bench.tests.test_bench_vit import _half_unsolved, _quarter_swapped

HRF = _tiny_hrf.HRF_CELL
HOST = _tiny_hrf.HOST_CELL
CFG = harness.config('hrformer_b_serve')
HRF_METRICS = ['hrf_network_ms', 'hrf_attention_ms', 'hrf_fuse_ms',
               'hrf_attention_roofline', 'hrf_serve_mfu', 'hrf_idle_pct']
HOST_METRICS = ['ingest_ms', 'h2d_ms']
# accepted readers that read these cells too, and the host cell's stages
HRF_SHARED = ['vit_crop_ms', 'vit_decode_ms', 'vit_solver_ms',
              'vit_k1_roofline']
HOST_STAGES = ['host_b256_crop_ms', 'host_b256_network_ms',
               'host_b256_decode_ms', 'host_b256_solver_ms',
               'host_b256_idle_pct']
HOST_SHARED = ['serve_mfu', 'k1_roofline']
MS = 1_000_000


def hand_forward(c: dict) -> int:
    """From the equations, 2 per multiply-add: the stem's two convs; the
    Bottlenecks; the transitions' 3x3 convs; per block on a branch of
    side h, padded side p and width C the qkv and proj linears on the p^2
    padded tokens (8 p^2 C^2), both attention products (4 * 49 p^2 C) and
    the FFN's 1x1, depthwise 3x3 and 1x1 convs on the h^2 pixels; per
    fusion the upsampling 1x1 convs at the input's side and the
    separable steps at each step's output side; the 1x1 head."""
    s, w, r = c['crop_size'] // 4, c['window'], c['mlp_ratio']
    stem, planes = c['stem_channels'], c['stage1_planes']
    ch = c['channels']
    side = [s // 2 ** i for i in range(len(ch))]
    pad = [-(-h // w) * w for h in side]

    def conv(cin, cout, k, h, groups=1):
        return 2 * h * h * cout * (cin // groups) * k * k

    out = conv(3, stem, 3, 2 * s) + conv(stem, stem, 3, s)
    cin = stem
    for _ in range(c['stage1_blocks']):
        out += (conv(cin, planes, 1, s) + conv(planes, planes, 3, s)
                + conv(planes, 4 * planes, 1, s))
        if cin != 4 * planes:
            out += conv(cin, 4 * planes, 1, s)
        cin = 4 * planes
    prev = [cin]
    for n, modules in zip((2, 3, 4), c['modules']):
        for i in range(n):
            if i < len(prev):
                if prev[i] != ch[i]:
                    out += conv(prev[i], ch[i], 3, side[i])
            else:
                out += conv(prev[-1], ch[i], 3, side[i])
        prev = ch[:n]
        for m in range(modules):
            for i in range(n):
                p2, h, cc = pad[i] ** 2, side[i], ch[i]
                out += c['blocks_per_branch'] * (
                    8 * p2 * cc * cc + 4 * w * w * p2 * cc
                    + conv(cc, r * cc, 1, h)
                    + conv(r * cc, r * cc, 3, h, groups=r * cc)
                    + conv(r * cc, cc, 1, h))
            outputs = 1 if (n == 4 and m == modules - 1) else n
            for i in range(outputs):
                for j in range(n):
                    if j > i:
                        out += conv(ch[j], ch[i], 1, side[j])
                    for k in range(i - j):
                        last = k == i - j - 1
                        h = side[j + k + 1]
                        out += conv(ch[j], ch[j], 3, h, groups=ch[j])
                        out += conv(ch[j], ch[i] if last else ch[j], 1, h)
    return out + conv(ch[0], c['num_keypoints'], 1, s)


def test_config_is_the_ports_hrformer_b():
    from esa_pose_estimation_tpu_torch.models.hrformer import HRFormer
    from esa_pose_estimation_tpu_torch.utils.config import hrformer_b_speed
    assert serve_hrformer.port_config(CFG) == hrformer_b_speed()
    assert [c // h for c, h in zip(CFG['channels'], CFG['heads'])] == \
        [CFG['head_dim']] * 4 == [39] * 4
    assert sum(ref_hrf.blocks_per_branch(CFG)) == CFG['blocks'] == 44
    assert CFG['heatmap_size'] * ref_hrf.stride(CFG) == CFG['crop_size']
    assert CFG['reduced'] == []
    with torch.device('meta'):
        ref = ref_hrf.HRFormer(CFG)
        port = HRFormer(hrformer_b_speed())
    assert sum(p.numel() for p in ref.parameters()) == CFG['parameters']
    assert sum(p.numel() for p in port.parameters()) == CFG['parameters']


@pytest.mark.parametrize('cfg', [CFG, {**CFG, **_tiny_hrf.TINY}],
                         ids=['hrformer_b', 'tiny'])
def test_forward_flops_against_hand_count(cfg):
    assert hrf_counts.forward_flops(cfg) == hand_forward(cfg)
    assert hrf_counts.forward_flops(cfg, batch=3) == 3 * hand_forward(cfg)


def test_frozen_counts():
    """The configuration's figures, ``hrf_counts.py``'s and the hand
    counts: 1,466 window-heads a row of blocks, 332,710 padded query
    tokens a frame over the 44 blocks."""
    assert CFG['flops_forward_per_image'] == hrf_counts.forward_flops(CFG) \
        == 142_288_594_768
    tokens = [133 ** 2, 70 ** 2, 35 ** 2, 21 ** 2]
    assert ref_hrf.padded_tokens(CFG) == tokens
    blocks = [14, 14, 12, 4]
    assert ref_hrf.blocks_per_branch(CFG) == blocks
    assert sum(b * t for b, t in zip(blocks, tokens)) == 332_710
    width = CFG['channels']
    windows_heads = sum(t // 49 * h for t, h in zip(tokens, CFG['heads']))
    assert windows_heads == 1_466
    flops = sum(b * t // 49 * h * 4 * 49 * 49 * 39
                for b, t, h in zip(blocks, tokens, CFG['heads']))
    assert CFG['attention_flops_per_image'] == \
        hrf_counts.attention_flops(CFG) == flops == 6_998_204_304
    q_k_v_o = sum(4 * 2 * b * t * c for b, t, c in zip(blocks, tokens, width))
    assert CFG['attention_bytes_per_image'] == \
        hrf_counts.attention_bytes(CFG) == q_k_v_o == 285_640_992
    assert hrf_counts.attention_bytes(CFG, batch=64) == 64 * q_k_v_o


def test_new_cells_and_names():
    bench = harness.benchmark()
    cells = {w['name']: w for w in bench['workloads']}
    assert cells[HRF]['config'] == 'hrformer_b_serve'
    assert cells[HRF]['chips'] == 1 and cells[HOST]['chips'] == 1
    assert cells[HOST]['config'] == 'hrnet_esa_serve'
    assert harness.workload(HRF)['driver'] == 'serve_hrformer'
    assert harness.workload(HOST)['driver'] == 'serve_host'
    assert harness.workload(HOST)['traffic']['ahead_calls'] == 4
    assert 'hrformer_b_serve' in [c['name'] for c in bench['configs']]
    for cell, names in ((HRF, HRF_METRICS + HRF_SHARED),
                        (HOST, HOST_METRICS + HOST_STAGES + HOST_SHARED)):
        e2e, per_layer = harness.metrics_of(bench, cell)
        assert sorted(m['name'] for m in e2e) == ['serve_images_per_s',
                                                  'setup_s']
        assert sorted(m['name'] for m in per_layer) == sorted(names)
    layers = {m['name']: m['layer'] for m in bench['per_layer']}
    assert layers['ingest_ms'] == layers['h2d_ms'] == 'host ingest'


class _Fake:
    def __init__(self, calls, spans=()):
        self._calls, self._spans = calls, list(spans)

    def calls(self):
        return list(self._calls)

    def spans(self, name=None):
        return [s for s in self._spans if name in (None, s.name)]


def _record(index, start, att_ms, fuse_ms, net_ms):
    """An HRFormer serving call: crop, then hrnet holding 44 attention and
    7 fuse stages among ``net_ms`` of its own, then decode, ransac_epnp
    and refine."""
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
    for b in range(44):
        t += round(net_ms / 51 * MS)
        span('attention', att_ms)
        if b % 6 == 5:
            t += round(net_ms / 51 * MS)
            span('fuse', fuse_ms)
    stamps.append(('/hrnet', t))
    for name in ('decode', 'ransac_epnp', 'refine'):
        span(name, 0.5)
    stamps.append(('/call', t))
    host = tuple(start * MS - 10_000 + k * 100 for k in range(5))
    return CallRecord(index, 3, index, 'cuda:0', host, tuple(stamps))


def _rec(cell, config, n_window, rate=80.0):
    return SimpleNamespace(workload=harness.workload(cell), config=config,
                           host_call_s=[0.001] * n_window, chips=1,
                           window_images_per_s=rate)


def test_hrformer_readers_on_synthetic_records(monkeypatch):
    from esa_pose_estimation_tpu_torch.obs import profiling
    tr = harness.workload(HRF)['traffic']
    head, tail = tr['warm_up_calls'] + 1, tr['trace_calls'] + 1
    calls = [_record(i, 900 * i, 0.3 + 0.01 * (i % 3), 5.0, 700.0)
             for i in range(head + 3 + tail)]
    monkeypatch.setattr(profiling, '_RECORDER', _Fake(calls))
    win = calls[head:head + 3]
    att = statistics.median(44 * (0.3 + 0.01 * (c.index % 3)) for c in win)
    net = statistics.median(
        sum(sum(v) for k, v in profiling.stage_ns(c).items()
            if k in ('hrnet', 'attention', 'fuse')) for c in win) * 1e-6
    busy = sum(c.stamps[-1][1] - c.stamps[0][1] for c in win)
    span = win[-1].stamps[-1][1] - win[0].stamps[0][1]
    bound = max(CFG['attention_flops_per_image'] / 989e12,
                CFG['attention_bytes_per_image'] / 3.35e12)
    expect = {'hrf_network_ms': net, 'hrf_attention_ms': att,
              'hrf_fuse_ms': 35.0,
              'hrf_attention_roofline': 100 * 64 * bound / (att * 1e-3),
              'hrf_serve_mfu': 100 * 80 * CFG['flops_forward_per_image']
              / 989e12,
              'hrf_idle_pct': 100 * (1 - busy / span)}
    rec = _rec(HRF, CFG, 3)
    for name in HRF_METRICS:
        assert harness.reader(name)(rec) == pytest.approx(expect[name]), name
    assert expect['hrf_attention_roofline'] < 100
    for name in HRF_METRICS[:4] + HRF_METRICS[5:]:
        assert harness.reader(name)(_rec(HRF, CFG, 4)) is None, name
    monkeypatch.setattr(profiling, '_RECORDER', _Fake([]))
    for name in HRF_METRICS[:4] + HRF_METRICS[5:]:
        assert harness.reader(name)(rec) is None, name


def test_host_readers_on_synthetic_records(monkeypatch):
    """Each window call's spans are those between the call before it and
    it: its frames' and its boxes'.  A program whose recorder keeps no
    spans (the parent's) reads nothing."""
    from esa_pose_estimation_tpu_torch.obs import profiling
    from esa_pose_estimation_tpu_torch.obs.profiling import (
        CallRecord,
        SpanRecord,
    )
    tr = harness.workload(HOST)['traffic']
    head, tail = tr['warm_up_calls'] + 1, tr['trace_calls'] + 1
    calls, spans = [], []
    for i in range(head + 3 + tail):
        t0 = 1000 * i * MS
        host = tuple(t0 + k * MS for k in range(5))
        calls.append(CallRecord(i, 1, i, 'cuda:0', host,
                                (('call', t0 + MS), ('/call', t0 + 80 * MS))))
        for j, (h_ms, d_ms) in enumerate(((20 + i, 13.5), (0.1, 0.01))):
            s0 = t0 - (3 - j) * 30 * MS
            spans.append(SpanRecord(2 * i + j, 'ingest', 'cpu',
                                    (s0, s0 + round(h_ms * MS)), None))
            spans.append(SpanRecord(2 * i + j, 'h2d', 'cuda:0', (s0, s0),
                                    (s0, s0 + round(d_ms * MS))))
    monkeypatch.setattr(profiling, '_RECORDER', _Fake(calls, spans))
    rec = _rec(HOST, harness.config('hrnet_esa_serve'), 3)
    assert harness.reader('ingest_ms')(rec) == pytest.approx(
        20 + head + 1 + 0.1)
    assert harness.reader('h2d_ms')(rec) == pytest.approx(13.51)

    class _NoSpans:
        def calls(self):
            return calls
    monkeypatch.setattr(profiling, '_RECORDER', _NoSpans())
    for name in HOST_METRICS:
        assert harness.reader(name)(rec) is None


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    return _tiny.artifact(str(tmp_path_factory.mktemp('w') / 'tiny.npz'))


def _context(cell, weights):
    return (_tiny_hrf.hrf_context() if cell == HRF
            else _tiny_hrf.host_context(weights))


@pytest.mark.parametrize('cell', [HRF, HOST])
def test_sound_run_is_correct(cell, weights):
    out = run.run_cell(_context(cell, weights))
    assert out['correct'], out['judged']
    assert out['attempted'] > 0 and out['failed'] == 0
    assert set(out['metrics']) == set(harness.workload(cell)['end_to_end'])


@pytest.mark.parametrize('cell', [HRF, HOST])
def test_traced_run_reports_the_readers(cell, weights):
    """The HRFormer readers, and the stage readers of both cells, read the
    tiny traced run; the ingest readers find nothing on the CPU, where
    ``to_device`` copies nothing and opens no span, and leave the line."""
    torch.manual_seed(0)
    ctx = _context(cell, weights)
    ctx.trace = True
    names = (HRF_METRICS + HRF_SHARED if cell == HRF
             else HOST_METRICS + HOST_STAGES + HOST_SHARED)
    ctx.per_layer[:] = [m for m in harness.benchmark()['per_layer']
                        if m['name'] in names]
    out = run.run_cell(ctx)
    assert out['correct'], out['judged']
    # K1's kernel runs only on a card
    assert sorted(out['layer']) == sorted(
        HOST_STAGES + ['serve_mfu'] if cell == HOST
        else HRF_METRICS + HRF_SHARED[:3])
    assert all(v['value'] > 0 for k, v in out['layer'].items()
               if not k.endswith('idle_pct'))


def _skip_block(monkeypatch):
    """The first block of the first module's highest branch left out."""
    plain = serve_hrformer.program_model

    def altered(*args, **kwargs):
        model = plain(*args, **kwargs)
        branch = model.HRModule_0.BranchBlocks_0
        branch.names = branch.names[1:]
        return model
    monkeypatch.setattr(serve_hrformer, 'program_model', altered)


@pytest.mark.parametrize('cell, fault', [
    (HRF, _half_unsolved), (HRF, _quarter_swapped), (HRF, _skip_block),
    (HOST, _half_unsolved), (HOST, _quarter_swapped)],
    ids=['hrf_half_unsolved', 'hrf_quarter_swapped', 'hrf_block_skipped',
         'host_half_unsolved', 'host_quarter_swapped'])
def test_planted_fault_fails(cell, fault, weights, monkeypatch):
    fault(monkeypatch)
    out = run.run_cell(_context(cell, weights))
    assert not out['correct'], out['judged']
