"""What the readers of the program's recorder share
(``esa_pose_estimation_tpu_torch.obs.profiling.Recorder``): the calls of
the cell's graph that the untraced window made, as the program recorded
them where the work happens (stage stamps inside the CUDA graph, host
phases of the graph entry), with no profiler running.

The window's calls are the graph's calls after the set-up's (serving:
``warm_up_calls`` and the one that sizes the kept rows; training:
``warm_up_calls``) and before the traced ones (``trace_calls`` and the
tracer's own first).  A program without the recorder, or a record that
does not hold exactly those calls, gives None: nothing to read."""

from __future__ import annotations

import statistics


def _recorder():
    try:
        from esa_pose_estimation_tpu_torch.obs import profiling
    except ImportError:
        return None, None
    get = getattr(profiling, 'recorder', None)
    return (get(), profiling) if get is not None else (None, None)


def window(rec):
    """(the window's calls, the program's ``profiling`` module), or
    None."""
    recorder, profiling = _recorder()
    if recorder is None:
        return None
    calls = recorder.calls()
    if not calls:
        return None
    graph = calls[-1].graph
    calls = [c for c in calls if c.graph == graph]
    tr = rec.workload['traffic']
    serving = rec.workload['driver'] == 'serve_closed'
    head = tr['warm_up_calls'] + (1 if serving else 0)
    tail = tr['trace_calls'] + 1
    total = calls[-1].index + 1
    win = [c for c in calls if head <= c.index < total - tail]
    if not win or len(win) != total - tail - head:
        return None                     # calls the rings no longer hold
    if serving and len(win) != len(rec.host_call_s):
        return None
    return win, profiling


def stage_ms(rec, *names: str) -> float | None:
    """The median over the window's calls of the device ms of the stages
    ``names`` together (their self times), per time the first of them ran
    in the call (a training call runs each step's stages)."""
    got = window(rec)
    if got is None:
        return None
    calls, profiling = got
    per_call = []
    for c in calls:
        ns = profiling.stage_ns(c)
        if names[0] not in ns:
            return None
        total = sum(sum(ns.get(n, ())) for n in names)
        per_call.append(total / len(ns[names[0]]))
    return statistics.median(per_call) * 1e-6


def lead_ms(rec) -> float | None:
    """The median over the window's calls of the device ms from the
    call's entry stamp to its first stage's: the input copies and what
    the graph runs before its first stage."""
    got = window(rec)
    if got is None:
        return None
    calls, _ = got
    if any(len(c.stamps) < 3 for c in calls):
        return None
    return statistics.median(c.stamps[1][1] - c.entry for c in calls) * 1e-6


def idle_pct(rec) -> float | None:
    """100 x the share of the window's device span (first call's entry to
    last call's exit) that no call's [entry, exit] covers."""
    got = window(rec)
    if got is None:
        return None
    calls, profiling = got
    share = profiling.idle_share(calls)
    return None if share is None else 100.0 * share


def entry_us(rec) -> float | None:
    """The mean over the window's calls of the graph entry's host µs: the
    sum of its phases (check, copy_in, launch, clone)."""
    got = window(rec)
    if got is None:
        return None
    calls, _ = got
    return statistics.fmean(c.host[-1] - c.host[0] for c in calls) * 1e-3
