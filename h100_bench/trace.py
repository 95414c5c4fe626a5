"""The traced run's record: a few calls under ``torch.profiler``, read
from its Chrome trace into device operations, the harness's call ranges
and the host's events; and device times by CUDA events.

The trace goes to a file under ``$TMPDIR`` that is deleted once read.
Only a few calls are profiled: a replay of the serving graph holds about
12,000 kernels, and each is an event.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

import torch

CALL = 'h100_bench.call'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation')
NAME_CHARS = 120        # a kernel's name in the breakdown, cut to this


class Op(NamedTuple):
    name: str
    cat: str
    start: float     # microseconds on the trace's clock
    end: float
    device: int


class Trace(NamedTuple):
    ops: list[Op]               # device operations inside the window
    host: list[Op]              # host events inside the window
    window: tuple[float, float]
    calls: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self, part: str = '') -> list[Op]:
        return [o for o in self.ops if o.cat == 'kernel'
                and part in o.name]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, the union of their
        intervals, averaged over the devices that ran any."""
        per_dev: dict[int, list] = {}
        for o in self.ops:
            per_dev.setdefault(o.device, []).append((o.start, o.end))
        if not per_dev:
            return 0.0
        total = 0.0
        for spans in per_dev.values():
            total += sum(e - s for s, e in _union(spans))
        return total / len(per_dev) * 1e-6

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps by the host event under each gap's start."""
        by_name: dict[str, float] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        spans = _union([(o.start, o.end) for o in self.ops])
        gaps = []
        edges = [self.window[0]] + [x for s in spans for x in s] \
            + [self.window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[self._host_at(a, b), (b - a) * 1e-6] for a, b in gaps[:n]]
        return {'device_ops': [[_short(k), v * 1e-6] for k, v in top],
                'idle_gaps': named}

    def _host_at(self, a: float, b: float) -> str:
        """The shortest host event that spans the gap's start (the host's
        innermost work then), else the one nearest before it."""
        host = [h for h in self.host if h.name != CALL
                and not h.name.startswith('ProfilerStep')]
        best = None
        for h in host:
            if h.start <= a < h.end:
                if best is None or h.end - h.start < best.end - best.start:
                    best = h
        if best is not None:
            return f'host: {best.name}'
        before = [h for h in host if h.end <= a]
        if before:
            return f'host after: {max(before, key=lambda h: h.end).name}'
        return 'host: none'


def _short(name: str) -> str:
    """A kernel's name without its namespaces, cut to ``NAME_CHARS``."""
    for part in ('void ', 'at::native::', '(anonymous namespace)::',
                 'at::', 'c10::'):
        name = name.replace(part, '')
    return name[:NAME_CHARS]


def _union(spans: list) -> list:
    out: list[list] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


@contextlib.contextmanager
def profiled(active: int):
    """A ``torch.profiler`` session over host and device that records
    ``active`` calls after one warm-up call (the tracer's own set-up);
    the caller makes ``active + 1`` calls, each inside :func:`call_range`,
    with ``prof.step()`` after each, and :func:`read` takes the trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=active,
                                   repeat=1)) as prof:
        yield prof


def call_range():
    """The range one profiled call runs inside."""
    return torch.profiler.record_function(CALL)


def read(prof) -> Trace:
    """The profiled calls' window (the first call range's start to the
    last one's end, or the last device operation's end if later), and the
    device and host events inside it."""
    fd, path = tempfile.mkstemp(suffix='.json',
                                dir=os.environ.get('TMPDIR'))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    calls = [e for e in events if e.get('name') == CALL
             and e.get('cat') == 'user_annotation' and 'dur' in e]
    dev, host = [], []
    for e in events:
        if 'dur' not in e or 'ts' not in e:
            continue
        op = Op(e.get('name', ''), e.get('cat', ''), float(e['ts']),
                float(e['ts']) + float(e['dur']),
                int(e.get('args', {}).get('device', 0) or 0))
        if op.cat in DEVICE_CATS:
            dev.append(op)
        elif op.cat in HOST_CATS:
            host.append(op)
    if not calls:
        return Trace([], [], (0.0, 0.0), 0)
    lo = min(float(c['ts']) for c in calls)
    hi = max(float(c['ts']) + float(c['dur']) for c in calls)
    dev = [o for o in dev if o.end > lo and o.start < hi + 1e6]
    if dev:
        hi = max(hi, max(o.end for o in dev))
    dev = [o._replace(start=max(o.start, lo), end=min(o.end, hi))
           for o in dev]
    host = [o for o in host if o.end > lo and o.start < hi]
    return Trace(dev, host, (lo, hi), len(calls))


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device ms of one ``fn()``: ``iters`` calls captured in a CUDA graph
    of the harness's own and replayed between two events, so the host's
    cost per call drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms
