"""The port's recorder (``obs/profiling.Recorder``, ``stage``,
``recording``) on the CPU, where a graph's call runs eagerly and its
stages take host stamps: the rings wrap, stage self times and the idle
share come out of stamps as computed by hand, ``Graphed`` and the
training steps keep one record a call with its phases and stages, the
switch keys the graphs and stops the records, and the recorded host
spans agree with the profiler's ranges on its clock.

Tolerances: exact on synthetic stamps; 200 µs between a recorded host
span and the profiler's range of the same name (the range's own entry
and exit cost lie between them)."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from esa_pose_estimation_tpu_torch import pipeline
from esa_pose_estimation_tpu_torch.data import synthetic as tsyn
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.obs import profiling
from esa_pose_estimation_tpu_torch.obs.profiling import (
    CallRecord,
    Recorder,
    stage,
)
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import config, graphs
from esa_pose_estimation_tpu_torch.utils.config import TrainConfig

CPU = torch.device('cpu')
SERVING = ['crop', 'hrnet', 'decode', 'ransac_epnp', 'refine']


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the process's place."""
    fresh = Recorder()
    monkeypatch.setattr(profiling, '_RECORDER', fresh)
    return fresh


def _labels(call: CallRecord) -> list[str]:
    return [label for label, _ in call.stamps]


def _staged(names):
    def run():
        for name in names:
            with stage(name):
                pass
    return run


# --- the rings -------------------------------------------------------------

def test_rings_wrap_at_capacity(monkeypatch):
    small = Recorder(calls=4, stamps=8)
    monkeypatch.setattr(profiling, '_RECORDER', small)
    graph = small.new_graph()
    for i in range(6):
        small.eager(graph, CPU, _staged(['a'] * (i % 2 + 1)))
    calls = small.calls()
    assert [c.seq for c in calls] == [2, 3, 4, 5]
    assert [c.index for c in calls] == [2, 3, 4, 5]
    assert small.seq == 6 and small.rings['cpu', None].issued == 6
    for c in calls:
        assert _labels(c) == ['call'] + ['a', '/a'] * (c.seq % 2 + 1) \
            + ['/call']
        times = [t for _, t in c.stamps]
        assert times == sorted(times)
        assert c.host[0] <= c.entry <= c.exit <= c.host[-1]
    for a, b in zip(calls, calls[1:]):
        assert a.exit <= b.entry


def test_stages_past_the_stride_are_not_stamped(monkeypatch):
    """Stride 8: entry, exit and six stage stamps; an outer stage keeps
    room for its exit, so nothing is left open."""
    small = Recorder(calls=2, stamps=8)
    monkeypatch.setattr(profiling, '_RECORDER', small)

    def nested():
        with stage('outer'):
            for name in ('x', 'y', 'z'):
                with stage(name):
                    pass
    small.eager(small.new_graph(), CPU, nested)
    (call,) = small.calls()
    assert _labels(call) == ['call', 'outer', 'x', '/x', 'y', '/y',
                             '/outer', '/call']
    assert set(profiling.stage_ns(call)) == {'outer', 'x', 'y'}


# --- arithmetic on synthetic stamps ------------------------------------------

def _call(seq, stamps, host=None, device='cuda:0'):
    host = host or (0, 1, 2, 3, 4)
    return CallRecord(seq, 0, seq, device, tuple(host), tuple(stamps))


def test_stage_self_times_from_synthetic_stamps():
    c = _call(0, [('call', 0), ('crop', 10), ('/crop', 20), ('hrnet', 20),
                  ('inner', 25), ('/inner', 35), ('/hrnet', 50),
                  ('step', 52), ('/step', 55), ('step', 56), ('/step', 60),
                  ('/call', 70)])
    assert profiling.stage_ns(c) == {'crop': [10], 'inner': [10],
                                     'hrnet': [20], 'step': [3, 4]}


def test_idle_share_and_gaps_from_synthetic_stamps():
    """Overlapping calls count once: [0, 60] and [50, 100] cover 100 of
    the span's 200, [150, 200] 50 more: a quarter idle."""
    calls = [_call(0, [('call', 0), ('/call', 60)], (-10, -8, -5, 20, 30)),
             _call(1, [('call', 50), ('/call', 100)], (40, 45, 48, 49, 95)),
             _call(2, [('call', 150), ('/call', 200)],
                   (96, 97, 99, 160, 165))]
    assert profiling.idle_share(calls) == pytest.approx(0.25)
    assert profiling.idle_share(calls[:1]) == 0.0
    assert profiling.idle_share([]) is None
    (gap,) = Recorder().idle_gaps(5, calls)
    assert gap.start == 100 and gap.seconds == pytest.approx(50e-9)
    assert gap.host == 'launch of call 2' and gap.device == 'cuda:0'
    # a second card: its gap [170, 180] begins after call 2's host phases
    two = calls + [_call(3, [('call', 100), ('/call', 170)],
                         (300, 301, 302, 303, 304), device='cuda:1'),
                   _call(4, [('call', 180), ('/call', 250)],
                         (305, 306, 307, 308, 309), device='cuda:1')]
    gaps = Recorder().idle_gaps(5, two)
    assert [(g.start, g.device, g.host) for g in gaps] == [
        (100, 'cuda:0', 'launch of call 2'), (170, 'cuda:1', 'no call')]


# --- the graphs' calls -------------------------------------------------------

def test_graphed_records_each_call_with_its_phases_and_stages(rec):
    model = HRNet(config.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0)).eval()
    frames = torch.rand((2, 96, 96),
                        generator=torch.Generator().manual_seed(1)) * 255
    boxes = torch.tensor([[8.0, 8.0, 80.0, 80.0]]).repeat(2, 1)
    serve = pipeline.make_jitted_pipeline(
        model, tsyn.spacecraft_points(n=6), crop_size=32, n_hypotheses=4,
        lm_iters=1)
    for i in range(3):
        serve(frames, boxes, torch.Generator().manual_seed(i))
    calls = rec.calls()
    assert [c.index for c in calls] == [0, 1, 2]
    assert len({c.graph for c in calls}) == 1
    for c in calls:
        assert _labels(c) == ['call'] + [x for n in SERVING
                                         for x in (n, '/' + n)] + ['/call']
        assert all(c.phase_ns(p) >= 0 for p in profiling.PHASES)
        assert c.phase_ns('launch') > 0.9 * (c.exit - c.entry)
        assert sorted(profiling.stage_ns(c)) == sorted(SERVING)


def test_graphed_without_tensors_and_nested_calls(rec):
    inner = graphs.Graphed(lambda x: x + 1)

    def outer_fn(x):
        with stage('a'):
            y = inner(x)
        with stage('b'):
            return y * 2
    outer = graphs.Graphed(outer_fn)
    assert torch.equal(outer(torch.ones(2)), torch.full((2,), 4.0))
    # the inner call is part of the outer one's launch
    (call,) = rec.calls()
    assert _labels(call) == ['call', 'a', '/a', 'b', '/b', '/call']
    assert torch.equal(inner(torch.ones(1)), torch.full((1,), 2.0))
    assert graphs.Graphed(lambda: 3)() == 3
    calls = rec.calls()
    assert len(calls) == 3 and len({c.graph for c in calls}) == 3


def test_training_steps_record_each_call_with_each_steps_stages(rec):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    state = tstate.create_train_state(model, TrainConfig(), 10)
    steps = tstate.make_train_steps(
        state, lambda m, x: (m(x) ** 2).mean(), n_inner=2)
    xs = [torch.randn(4, 3) for _ in range(2)]
    for _ in range(3):
        losses = steps(xs)
    assert losses.shape == (2,) and state.step == 6
    calls = rec.calls()
    assert [c.index for c in calls] == [0, 1, 2]
    step = ['forward', '/forward', 'backward', '/backward', 'optimizer',
            '/optimizer']
    for c in calls:
        assert _labels(c) == ['call'] + step * 2 + ['/call']
        ns = profiling.stage_ns(c)
        assert {k: len(v) for k, v in ns.items()} == {
            'forward': 2, 'backward': 2, 'optimizer': 2}


def test_a_call_that_raises_keeps_nothing(rec):
    def boom(x):
        with stage('a'):
            raise ValueError('boom')
    with pytest.raises(ValueError):
        graphs.Graphed(boom)(torch.ones(1))
    assert rec.calls() == [] and rec._target is None
    with stage('outside'):          # no call open: a range alone
        pass
    assert rec.calls() == []


# --- the switch --------------------------------------------------------------

def test_recording_off_changes_the_key_and_records_nothing(rec):
    x = torch.zeros(2)
    on = graphs.graph_key((x,), {})
    with profiling.recording(False):
        off = graphs.graph_key((x,), {})
        assert not rec.on
        graphs.Graphed(lambda t: t + 1)(x)
        rec.eager(rec.new_graph(), CPU, _staged(['a']))
        with rec.capturing(CPU) as graph:
            assert graph is None
    assert rec.on and on != off and dict(on[2])['RECORDING']
    assert rec.calls() == []
    profiling.recording(False)
    try:
        assert graphs.graph_key((x,), {}) == off
    finally:
        profiling.recording(True)
    assert graphs.graph_key((x,), {}) == on


# --- one clock ---------------------------------------------------------------

def _annotations(prof, tmp_path) -> dict[str, list[tuple[float, float]]]:
    """The profiler's ranges by name, (start, end) in ns on its clock."""
    path = os.path.join(tmp_path, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace['baseTimeNanoseconds']
    out: dict[str, list] = {}
    for e in trace['traceEvents']:
        if e.get('cat') == 'user_annotation' and 'dur' in e:
            start = base + float(e['ts']) * 1e3
            out.setdefault(e['name'], []).append(
                (start, start + float(e['dur']) * 1e3))
    return {k: sorted(v) for k, v in out.items()}


def test_host_spans_agree_with_the_profilers_ranges(rec, tmp_path):
    serve = graphs.Graphed(lambda x: _staged(['crop', 'hrnet'])() or x * 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('warm_up'):    # the tracer's first range
            pass
        for _ in range(4):
            serve(torch.ones(8))
    got = _annotations(prof, tmp_path)
    calls = rec.calls()
    assert len(calls) == 4
    spans: dict[str, list] = {}
    for c in calls:
        for i, phase in enumerate(profiling.PHASES):
            spans.setdefault('graph.' + phase, []).append(
                (c.host[i], c.host[i + 1]))
        stamps = dict(c.stamps)
        for name in ('crop', 'hrnet'):
            spans.setdefault(name, []).append((stamps[name],
                                               stamps['/' + name]))
    assert set(spans) <= set(got)
    for name, ours in spans.items():
        assert len(got[name]) == len(ours), name
        for (a0, a1), (b0, b1) in zip(ours, got[name]):
            assert abs(a0 - b0) < 200e3 and abs(a1 - b1) < 200e3, (
                name, a0 - b0, a1 - b1)
