"""What the host-ingest cell's readers share: the program's recorder spans
(``obs/profiling.span``, which ``data/speed.to_device`` opens for each
array it sends to the card: ``ingest`` and ``h2d``) of the untraced
window's calls.  A call's spans are those opened between the graph call
before it and its own graph call: its frames' and its boxes'.  A program
without spans, or a window call without one, gives None."""

from __future__ import annotations

import statistics

from h100_bench.layer_metrics import _vit_spans


def call_ms(rec, name: str, device: bool) -> float | None:
    """The median over the window's calls of the ms of the spans ``name``
    sent for the call, summed: the host's time, or with ``device`` the
    card's time between each span's two stamps."""
    got = _vit_spans.window(rec)
    if got is None:
        return None
    calls, profiling = got
    recorder = profiling.recorder()
    if not hasattr(recorder, 'spans'):
        return None
    spans = recorder.spans(name)
    graph = [c for c in recorder.calls() if c.graph == calls[0].graph]
    exits = {c.index: c.host[-1] for c in graph}
    per_call = []
    for c in calls:
        lo = exits.get(c.index - 1)
        if lo is None:
            return None
        mine = [s for s in spans if lo < s.host[0] < c.host[0]]
        if not mine or (device and any(s.stamps is None for s in mine)):
            return None
        per_call.append(sum(s.device_ns if device else s.host_ns
                            for s in mine))
    return statistics.median(per_call) * 1e-6
