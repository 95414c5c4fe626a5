"""The readers of the program's recorder (``layer_metrics/_spans.py`` and
the fifteen metrics over it): each on synthetic call records against
the value computed by hand, None without records or without the
recorder; and, at ``hrnet_tiny`` size on the CPU, a traced run of each
cell reporting its five, with the serving window's calls counted as the
harness counts them."""

import statistics
from types import SimpleNamespace

import pytest
import torch

from h100_bench import harness
from h100_bench.layer_metrics import _spans
from h100_bench.tests import _tiny

MS = 1_000_000
SERVE_NEW = {
    'serve_offline_b256': ['b256_crop_ms', 'b256_network_ms',
                           'b256_decode_ms', 'b256_solver_ms',
                           'b256_idle_pct'],
    'serve_online_b1': ['b1_network_ms', 'b1_ransac_ms', 'b1_refine_ms',
                        'b1_entry_us', 'b1_idle_pct'],
}
TRAIN_NEW = ['step_forward_ms', 'step_backward_ms', 'step_optimizer_ms',
             'train_copy_in_ms', 'train_idle_pct']
NEW = {**SERVE_NEW, 'train_b32': TRAIN_NEW}


class _Fake:
    """A recorder that holds the given records."""

    def __init__(self, calls):
        self._calls = calls

    def calls(self):
        return list(self._calls)


def _record(index, start, stages, host_us=100, graph=7):
    """A call whose stages (name, ms) follow each other from ``start`` ms
    after a 1 ms lead, and whose host phases last ``host_us`` together."""
    from esa_pose_estimation_tpu_torch.obs.profiling import CallRecord
    t = start * MS + MS
    stamps = [('call', start * MS)]
    for name, ms in stages:
        stamps += [(name, t), ('/' + name, t + round(ms * MS))]
        t += round(ms * MS)
    stamps.append(('/call', t + MS // 2))
    h0 = start * MS - 10_000
    host = tuple(h0 + k * host_us * 250 for k in range(5))
    return CallRecord(index, graph, index, 'cuda:0', host, tuple(stamps))


def _serving(n=8):
    """A call every 25 ms, of 19, 21.1 or 23.2 ms by its index modulo 3."""
    return [_record(i, 25 * i, [('crop', 1 + 0.1 * (i % 3)),
                                ('hrnet', 10 + i % 3), ('decode', 0.5),
                                ('ransac_epnp', 4 + i % 3), ('refine', 2)],
                    host_us=100 + 10 * i)
            for i in range(n)]


def _training(n=7):
    steps = [(name, ms * (1 + 0.01 * i)) for i in range(2)
             for name, ms in (('forward', 20), ('backward', 40),
                              ('optimizer', 5))]
    return [_record(i, 200 * i, [(n, ms + i) for n, ms in steps])
            for i in range(n)]


def _rec(cell, n_window):
    wl = harness.workload(cell)
    return SimpleNamespace(workload=wl, host_call_s=[0.001] * n_window)


@pytest.fixture
def recorded(monkeypatch):
    from esa_pose_estimation_tpu_torch.obs import profiling

    def use(calls):
        monkeypatch.setattr(profiling, '_RECORDER', _Fake(calls))
    return use


def _window(cell, calls):
    tr = harness.workload(cell)['traffic']
    head = tr['warm_up_calls'] + (cell != 'train_b32')
    return calls[head:len(calls) - tr['trace_calls'] - 1]


def _stage_ms(calls, *names):
    def one(c):
        d = dict()
        for (a, ta), (b, tb) in zip(c.stamps, c.stamps[1:]):
            if b == '/' + a:
                d.setdefault(a, []).append(tb - ta)
        return sum(sum(d.get(n, ())) for n in names) / len(d[names[0]])
    return statistics.median(one(c) for c in calls) / MS


@pytest.mark.parametrize('cell', ['serve_offline_b256', 'serve_online_b1'])
def test_serving_readers_on_synthetic_records(cell, recorded):
    tr = harness.workload(cell)['traffic']
    n = tr['warm_up_calls'] + 1 + 3 + tr['trace_calls'] + 1
    calls = _serving(n)
    recorded(calls)
    win = _window(cell, calls)
    assert len(win) == 3
    rec = _rec(cell, 3)
    span = win[-1].exit - win[0].entry
    busy = sum(c.exit - c.entry for c in win)
    expect = {
        'crop_ms': _stage_ms(win, 'crop'),
        'network_ms': _stage_ms(win, 'hrnet'),
        'decode_ms': _stage_ms(win, 'decode'),
        'solver_ms': _stage_ms(win, 'ransac_epnp', 'refine'),
        'ransac_ms': _stage_ms(win, 'ransac_epnp'),
        'refine_ms': _stage_ms(win, 'refine'),
        'idle_pct': 100 * (1 - busy / span),
        'entry_us': statistics.fmean(c.host[-1] - c.host[0]
                                     for c in win) / 1e3,
    }
    # by hand: the window's calls are indices 0, 1, 2 modulo 3 (3 calls of
    # set-up at 256, 801 at 1), of 19, 21.1 and 23.2 ms from 25 ms apart
    assert [c.index % 3 for c in win] == [0, 1, 2]
    assert expect['network_ms'] == pytest.approx(11)
    assert expect['solver_ms'] == pytest.approx(5 + 2)
    assert expect['idle_pct'] == pytest.approx(100 * (1 - 63.3 / 73.2))
    for name in SERVE_NEW[cell]:
        got = harness.reader(name)(rec)
        assert got == pytest.approx(expect[name.split('_', 1)[1]]), name
    # a window that the harness counts otherwise reads nothing
    for name in SERVE_NEW[cell]:
        assert harness.reader(name)(_rec(cell, 4)) is None


def test_training_readers_on_synthetic_records(recorded):
    cell = 'train_b32'
    tr = harness.workload(cell)['traffic']
    calls = _training(tr['warm_up_calls'] + 3 + tr['trace_calls'] + 1)
    recorded(calls)
    win = _window(cell, calls)
    assert [c.index for c in win] == [2, 3, 4]
    rec = _rec(cell, 0)
    i = 3                                     # the median call
    expect = {
        'step_forward_ms': (20 + 20.2) / 2 + i,
        'step_backward_ms': (40 + 40.4) / 2 + i,
        'step_optimizer_ms': (5 + 5.05) / 2 + i,
        'train_copy_in_ms': 1.0,
        'train_idle_pct': 100 * (1 - sum(c.exit - c.entry for c in win)
                                 / (win[-1].exit - win[0].entry)),
    }
    for name, value in expect.items():
        assert harness.reader(name)(rec) == pytest.approx(value), name


@pytest.mark.parametrize('cell', list(NEW))
def test_readers_read_nothing_without_records(cell, recorded, monkeypatch):
    rec = _rec(cell, 3)
    recorded([])
    for name in NEW[cell]:
        assert harness.reader(name)(rec) is None
    # calls the rings no longer hold: the window's first is gone
    calls = _serving(20) if cell != 'train_b32' else _training(20)
    recorded(calls[5:])
    for name in NEW[cell]:
        assert harness.reader(name)(_rec(cell, 20 - 3 - 9)) is None
    # a program without the recorder (the parent of this reader)
    from esa_pose_estimation_tpu_torch.obs import profiling
    monkeypatch.delattr(profiling, 'recorder')
    for name in NEW[cell]:
        assert harness.reader(name)(rec) is None


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    return _tiny.artifact(str(tmp_path_factory.mktemp('w') / 'tiny.npz'))


@pytest.mark.parametrize('cell', list(NEW))
def test_traced_run_reports_the_recorders_metrics(cell, weights,
                                                  monkeypatch):
    """The cell's traced run at ``hrnet_tiny`` with its five new readers
    (the others time a layer on a card); the serving window's calls are
    the harness's own count."""
    from h100_bench import run
    seen = []
    plain = harness.layer_metrics

    def spy(per_layer, rec):
        seen.append((_spans.window(rec), len(rec.host_call_s)))
        return plain(per_layer, rec)
    monkeypatch.setattr(harness, 'layer_metrics', spy)
    torch.manual_seed(0)
    ctx = _tiny.context(cell, weights)
    ctx.trace = True
    names = NEW[cell]
    ctx.per_layer[:] = [m for m in harness.benchmark()['per_layer']
                        if m['name'] in names]
    out = run.run_cell(ctx)
    assert out['correct'], out['judged']
    assert sorted(out['layer']) == sorted(names)
    assert all(v['value'] >= 0 for v in out['layer'].values())
    (win, profiling), host_calls = seen[0]
    assert win and all(c.index >= 0 for c in win)
    if cell != 'train_b32':
        assert len(win) == host_calls
