"""The recorder's spans (``obs/profiling.span``), which mark the program's
eager work outside its graphs, and the host-to-card path that opens them
(``data/speed.to_device``), on the CPU: host times kept and read on the
profiler's clock, no stamps without a card, nothing kept with the
recorder off or from a span that raised, and ``to_device``'s CPU path
unchanged."""

import time

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu_torch.data import speed
from esa_pose_estimation_tpu_torch.obs import profiling


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_span_keeps_host_times():
    rec = profiling.Recorder(calls=4, stamps=8)
    t0 = time.time_ns()
    with rec.span('ingest'):
        time.sleep(0.002)
        with rec.span('h2d', torch.device('cpu')):
            pass
    t1 = time.time_ns()
    spans = rec.spans()
    assert [s.name for s in spans] == ['h2d', 'ingest']
    outer = rec.spans('ingest')[0]
    assert outer.device == 'cpu' and outer.stamps is None
    assert outer.device_ns is None and outer.host_ns >= 2_000_000
    # the profiler's clock: time_ns at start plus the host's elapsed ns
    assert t0 - 1_000_000 <= outer.host[0] <= outer.host[1] <= t1 + 1_000_000
    inner = rec.spans('h2d')[0]
    assert outer.host[0] <= inner.host[0] <= inner.host[1] <= outer.host[1]
    assert [s.seq for s in spans] == [0, 1]


def test_span_keeps_nothing_off_or_raising():
    rec = profiling.Recorder(calls=4, stamps=8)
    rec.on = False
    with rec.span('ingest'):
        pass
    rec.on = True
    with pytest.raises(ValueError):
        with rec.span('ingest'):
            raise ValueError('a copy that failed')
    assert rec.spans() == [] and rec.span_seq == 0


def test_spans_ring_keeps_the_latest(monkeypatch):
    monkeypatch.setattr(profiling, 'SPAN_CALLS', 3)
    rec = profiling.Recorder(calls=4, stamps=8)
    for i in range(5):
        with rec.span(f's{i}'):
            pass
    assert [s.name for s in rec.spans()] == ['s2', 's3', 's4']


def test_to_device_cpu_shares_memory_and_opens_no_span():
    """On the CPU an array is shared, not copied: nothing is pinned or
    sent, so no span is opened."""
    rec = profiling.recorder()
    before = rec.span_seq
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    t = speed.to_device(a, 'cpu')
    assert t.data_ptr() == a.ctypes.data and torch.equal(
        t, torch.from_numpy(a))
    x = torch.ones(2)
    assert speed.to_device(x, 'cpu') is x
    assert rec.span_seq == before
