"""What the ViTPose cell's readers share: the untraced window's calls as
``_spans.window`` gives them for serving (it keys serving on
``drivers/serve_closed.py``; ``serve_vit.py`` runs the same loop), a
stage's device ms a whole call, and the window's idle share."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

from h100_bench.layer_metrics import _spans


def window(rec):
    """(the window's calls, the program's ``profiling``), or None."""
    return _spans.window(SimpleNamespace(
        workload={**rec.workload, 'driver': 'serve_closed'},
        host_call_s=rec.host_call_s))


def call_ms(rec, *names: str) -> float | None:
    """The median over the window's calls of the device ms of the stages
    ``names`` together, their self times summed over every time each ran
    in the call (``attention`` runs once a block); None where the first
    did not run."""
    got = window(rec)
    if got is None:
        return None
    calls, profiling = got
    per_call = []
    for c in calls:
        ns = profiling.stage_ns(c)
        if names[0] not in ns:
            return None
        per_call.append(sum(sum(ns.get(n, ())) for n in names))
    return statistics.median(per_call) * 1e-6


def idle_pct(rec) -> float | None:
    """``_spans.idle_pct`` over this window: 100 x the share of its device
    span that no call's [entry, exit] covers."""
    got = window(rec)
    if got is None:
        return None
    calls, profiling = got
    share = profiling.idle_share(calls)
    return None if share is None else 100.0 * share
