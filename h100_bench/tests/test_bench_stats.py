"""The host-clock statistics on synthetic timings."""

import pytest

from h100_bench import harness


def test_rate_counts_whole_calls(monkeypatch):
    """A window of calls of 0.3 s each over 1 s runs four whole calls
    (the last ends past the second) and its rate is over all of them."""
    clock = iter([0.0, 0.0, 0.3, 0.3, 0.6, 0.6, 0.9, 0.9, 1.2])
    monkeypatch.setattr(harness.time, 'perf_counter', lambda: next(clock))
    win = harness.Window(1.0)
    win.run(lambda i: None)
    assert win.calls == 4
    assert win.elapsed == pytest.approx(1.2)
    assert harness.rate(4 * 256, win.elapsed) == pytest.approx(1024 / 1.2)


def test_stall_counts():
    """A stall between calls lowers the rate: the window is the calls'
    span, not the sum of their times."""
    win = harness.Window(0)
    win.starts, win.ends = [0.0, 2.0], [0.5, 2.5]
    assert harness.rate(2, win.elapsed) == pytest.approx(0.8)


def test_p95_over_all_frames():
    xs = [float(i) for i in range(1, 101)]
    assert harness.p95(xs) == pytest.approx(95.05)
    assert harness.p95([5.0]) == 5.0
    tail = [1.0] * 94 + [10.0] * 6
    assert harness.p95(tail) == pytest.approx(10.0)



def test_ahead_waits_for_all_sent():
    """Calls sent ahead: at most ``depth`` are in flight past the one
    waited for, each is waited for in order, nothing is sent once the
    time is up, and the window closes at the last wait's end."""
    sent, waited, flight = [], [], []

    def send(i):
        sent.append(i)
        flight.append(len(sent) - len(waited))
        return i

    win = harness.Window(0.05)
    win.run_ahead(send, waited.append, 3)
    assert waited == sent and len(sent) > 4
    assert max(flight) == 4
    assert win.calls == len(win.ends) == len(sent)
    assert win.elapsed == win.ends[-1] - win.starts[0]
    assert all(e >= s for s, e in zip(win.starts, win.ends))
