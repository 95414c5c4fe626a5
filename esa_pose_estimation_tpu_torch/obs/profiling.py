"""Timing and profiling helpers (torch port of the JAX package's
``obs/profiling.py``).

In place of the reference's ``time.clock()`` spans and its forward-hook
FLOPs summariser (main.py:42-44 timing, main.py:54-173
``get_model_summary``):

* :class:`Timer` — host-clock spans that wait for the card: the tensors
  given to the span are synchronised on their CUDA devices at its end
  (work is queued asynchronously; a span without the wait measures the
  enqueue);
* :func:`trace` — ``torch.profiler`` around a block, writing a trace that
  TensorBoard's profiler plugin (and Perfetto) reads;
* :func:`model_summary` — parameters per top-level child, and the FLOPs
  of one forward as ``torch.utils.flop_counter.FlopCounterMode`` counts
  them from the shapes of the products it sees (convolutions, matrix
  products and attention, 2 per multiply-add); element-wise work,
  BatchNorm, pooling and resampling are not counted.  The JAX module reads
  XLA's ``cost_analysis``, which also estimates the bytes accessed; torch
  has no compiler estimate of bytes, so none is reported;
* :class:`MultiClassPrecisionRecall` (net_utils.py:241-270);
* :class:`Recorder` — the program's flight recorder, on by default
  (:func:`recording`): :func:`stage` marks a stage of a compiled program,
  and every call of a CUDA graph (``utils/graphs.Graphed``,
  ``train/state.StepGraph``) keeps a record of its host phases
  (:data:`PHASES`) and of its device stamps, with no profiler running.

The recorder.  A replay of a CUDA graph emits no host range, so a
profiler sees a graph as one launch.  Inside a capture made by
``utils/graphs.capture``, :func:`stage` launches a one-thread kernel
(``csrc/stamp.cu``) at the stage's entry and exit, which writes the
card's ``%globaltimer`` into a ring on the card, at
``ring[(count % calls) * stride + index]``; a call's own entry stamp
(before its input copies) and exit stamp (after its output clones, which
also moves ``count`` on) are launched eagerly around the replay.  All of
a call's stamps run in stream order, so they land in one slot however
many calls are in flight, and nothing is copied per call.  The host keeps
``perf_counter_ns`` at the boundaries of each call's phases, with the
call's sequence number and graph, in a bounded ring of its own.
:meth:`Recorder.calls` reads both rings (waiting for the cards) and puts
every time on the profiler's clock: a Chrome trace's ``ts`` (µs) plus its
``baseTimeNanoseconds``, which is ``time.time_ns()``.  Host times convert
by one (``time_ns``, ``perf_counter_ns``) pair taken at start; a card's
stamps by a calibration made at its first capture and again at each
read or :meth:`Recorder.calibrate` (host ns, stamp, synchronize, host
ns, :data:`CALIBRATION_ROUNDS` rounds), along the line fitted to them.  On
the CPU, where a graph runs eagerly, the same records hold host
stamps.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import threading
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from esa_pose_estimation_tpu_torch import _build


def _synchronize(result) -> None:
    """Wait for every CUDA device that a tensor in ``result`` lives on."""
    from torch.utils._pytree import tree_leaves
    devices = {t.device for t in tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class _Span:
    """The handle :meth:`Timer.span` yields: assign what to wait for to
    ``.result`` inside the span."""

    __slots__ = ('result',)

    def __init__(self, result=None):
        self.result = result


class Timer:
    """Synchronised host-clock spans::

        with t.span() as s:
            s.result = model(x)     # waited for at the span's end

    ``result=`` serves for tensors that exist at entry (timing the wait
    for work already queued)."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def span(self, result=None):
        s = _Span(result)
        start = time.perf_counter()
        try:
            yield s
        finally:
            if s.result is not None:
                _synchronize(s.result)
            self.times.append(time.perf_counter() - start)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def total(self) -> float:
        return float(np.sum(self.times))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CPU, and CUDA where a card is present) and
    write a trace under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def param_count(params: Any) -> int:
    """Elements of a module's parameters, or of an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return int(sum(p.numel() for p in params))


@torch.no_grad()
def model_summary(model: torch.nn.Module, input_shape: tuple[int, ...],
                  train: bool = False) -> dict[str, Any]:
    """Parameter counts and the FLOPs of one forward on zeros of
    ``input_shape`` (on the model's device; the module docstring says what
    is counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    per_module = {name: param_count(child)
                  for name, child in model.named_children()}
    total = param_count(model)
    p = next(model.parameters())
    was_training = model.training
    model.train(train)
    try:
        with FlopCounterMode(display=False) as counter:
            model(torch.zeros(input_shape, device=p.device))
    finally:
        model.train(was_training)
    return {'total_params': total, 'per_module': per_module,
            'flops': int(counter.get_total_flops())}


class MultiClassPrecisionRecall:
    """Per-class precision and recall accumulator (net_utils.py:241-270)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.tp = np.zeros(self.num_classes)
        self.fp = np.zeros(self.num_classes)
        self.fn = np.zeros(self.num_classes)

    def update(self, pred, target):
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        for c in range(self.num_classes):
            self.tp[c] += np.sum((pred == c) & (target == c))
            self.fp[c] += np.sum((pred == c) & (target != c))
            self.fn[c] += np.sum((pred != c) & (target == c))

    def precision(self) -> np.ndarray:
        return self.tp / np.maximum(self.tp + self.fp, 1)

    def recall(self) -> np.ndarray:
        return self.tp / np.maximum(self.tp + self.fn, 1)


# ---------------------------------------------------------------------------
# The recorder (see the module's docstring)

RING_CALLS = 16_384     # calls a ring keeps: 16 MiB of stamps on a card
RING_STAMPS = 128       # stamps a call may hold: entry, exit and stages'
# (a ViTPose-H serving call holds 80, its 32 blocks' attention 64 of them)
CALIBRATION_ROUNDS = 16
PHASES = ('check', 'copy_in', 'launch', 'clone')
_ENTRY, _EXIT, _FIRST_STAGE = 0, 1, 2    # a call's stamp indices

_fns: dict = {}


def _launch_stamp(device: torch.device, ring: int, count: int, calls: int,
                  stride: int, index: int, advance: bool) -> None:
    """One stamp kernel on ``device``'s current stream (captured into a
    graph when that stream is capturing)."""
    fn = _fns.get('stamp_launch')
    if fn is None:
        fn = _build.load('stamp').stamp_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns['stamp_launch'] = fn
    # the raw handle: a Stream object costs ~5 us of host a stamp
    err = fn(device.index, ring, count, calls, stride, index, int(advance),
             torch._C._cuda_getCurrentRawStream(device.index))
    _build.check(err, f'stamp on {device}')


class _Ring:
    """One device's stamps: ``calls`` slots of ``stride`` int64 stamps (a
    card's ``%globaltimer`` ns, or on the CPU ``perf_counter_ns``), and
    ``issued``, the calls whose exit stamp was launched (on a card the
    device's own ``count`` follows it in stream order)."""

    def __init__(self, device: torch.device, calls: int, stride: int):
        self.device, self.calls, self.stride = device, calls, stride
        self.issued = 0
        self.cuda = device.type == 'cuda'
        # calibration points: (stamp ns, profiler ns, error ns)
        self.points: list[tuple[int, int, int]] = []
        if self.cuda:
            self.stamps = torch.zeros(calls * stride, dtype=torch.int64,
                                      device=device)
            self.count = torch.zeros(1, dtype=torch.int64, device=device)
            self.probe = torch.zeros(2, dtype=torch.int64, device=device)
        else:
            self.stamps = np.zeros(calls * stride, dtype=np.int64)

    def stamp(self, index: int, advance: bool = False) -> None:
        if self.cuda:
            _launch_stamp(self.device, self.stamps.data_ptr(),
                          self.count.data_ptr(), self.calls, self.stride,
                          index, advance)
        else:
            self.stamps[(self.issued % self.calls) * self.stride
                        + index] = time.perf_counter_ns()
        if advance:
            self.issued += 1

    def calibrate(self, host_offset: int) -> None:
        """One more point of the card's clock against the profiler's.  A
        stamp launched at host time h0 and waited for at h1 ran between
        them, so the clocks' offset lies in [stamp - h1, stamp - h0]; the
        rounds' intervals are intersected, and the point is the middle of
        what is left (its error at most half of that)."""
        lo, hi = None, None
        probe = self.probe.data_ptr()
        for _ in range(CALIBRATION_ROUNDS):
            h0 = time.perf_counter_ns()
            _launch_stamp(self.device, probe, probe + 8, 1, 1, 0, False)
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            g = int(self.probe[0].item())
            lo = g - h1 if lo is None else max(lo, g - h1)
            hi = g - h0 if hi is None else min(hi, g - h0)
        # with hi < lo (the card's clock stepped) the middle still serves
        offset = (lo + hi) // 2
        self.points.append((g, g - offset + host_offset, abs(hi - lo) // 2))

    def read(self) -> np.ndarray:
        return self.stamps.cpu().numpy() if self.cuda else self.stamps

    def to_profiler(self, ns: np.ndarray, host_offset: int) -> list[int]:
        """Stamps on the profiler's clock, along the line fitted to the
        calibration points, each weighted by its error: the rate from
        points seconds apart, not from two close ones, whose errors of a
        few µs would tilt it by tens of ppm."""
        if not self.cuda:
            return [int(t) + host_offset for t in ns]
        g0, h0 = self.points[0][0], self.points[0][1]
        x = np.array([g - g0 for g, _, _ in self.points], dtype=np.float64)
        y = np.array([h - h0 for _, h, _ in self.points], dtype=np.float64)
        w = 1.0 / (np.array([e for _, _, e in self.points], np.float64)
                   + 1e3) ** 2
        xm, ym = np.average(x, weights=w), np.average(y, weights=w)
        spread = np.average((x - xm) ** 2, weights=w)
        slope = (np.average((x - xm) * (y - ym), weights=w) / spread
                 if spread > 1e16 else 1.0)        # points 0.1 s apart
        return [h0 + round(ym + (int(t) - g0 - xm) * slope) for t in ns]


class _Stamps:
    """Where :func:`stage` stamps go on one thread: the slot that a graph
    being captured fills at each replay, or an eager call's own.  A stage
    that would leave no room for the exits of the stages open is not
    stamped."""

    __slots__ = ('ring', 'labels', 'open', 'thread')

    def __init__(self, ring: _Ring, labels: list):
        self.ring, self.labels, self.open = ring, labels, 0
        self.thread = threading.get_ident()

    def enter(self, name: str) -> bool:
        index = _FIRST_STAGE + len(self.labels)
        if index + 2 + self.open > self.ring.stride:
            return False
        self.labels.append(name)
        self.open += 1
        self.ring.stamp(index)
        return True

    def exit(self, name: str) -> None:
        self.ring.stamp(_FIRST_STAGE + len(self.labels))
        self.labels.append('/' + name)
        self.open -= 1


class CallRecord(NamedTuple):
    """One call of a graph, every time on the profiler's clock (ns)."""
    seq: int         # the recorder's call number, shared by its spans
    graph: int       # the graph it replayed (on the CPU: the program)
    index: int       # its number among that graph's calls, from 0
    device: str
    host: tuple[int, ...]   # the boundaries of PHASES: 5 host times
    stamps: tuple[tuple[str, int], ...]   # ('call', entry), stages'
    # ('name', t) at entry and ('/name', t) at exit, ('/call', exit)

    @property
    def entry(self) -> int:
        return self.stamps[0][1]

    @property
    def exit(self) -> int:
        return self.stamps[-1][1]

    def phase_ns(self, phase: str) -> int:
        i = PHASES.index(phase)
        return self.host[i + 1] - self.host[i]


class Gap(NamedTuple):
    """A stretch in which a device ran none of the recorded calls."""
    start: int       # profiler-clock ns
    seconds: float
    device: str
    host: str        # the host phase open at its start ('check of call
    # 12'), or 'no call'


class _Call:
    """One call's record, opened by :meth:`Recorder.call`: the host time
    at each phase boundary, the entry stamp at :meth:`copy_in` and the
    exit stamp when the ``with`` block ends.  Under an active profiler
    each phase is a ``graph.<phase>`` range too.  A call that raises keeps
    nothing."""

    __slots__ = ('rec', 'ns', 'range', 'ring', 'graph', 'labels', 'stamps',
                 'prev')

    def __init__(self, rec: 'Recorder'):
        self.rec, self.ring, self.stamps, self.range = rec, None, None, None
        self.ns = [time.perf_counter_ns()]
        self._range('check')

    def _range(self, phase: str) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function('graph.' + phase)
            self.range.__enter__()

    def __enter__(self) -> '_Call':
        return self

    def copy_in(self, graph: int, device: torch.device) -> None:
        """The check is over: the entry stamp, then the input copies.  On
        the CPU the call's stages stamp its own slot."""
        self.ns.append(time.perf_counter_ns())
        self._range('copy_in')
        rec = self.rec
        ring = self.ring = rec.ring(device)
        self.graph = graph
        if ring.cuda:
            self.labels = rec.labels.get(graph, ())
        else:
            self.labels = []
            self.stamps = _Stamps(ring, self.labels)
            self.prev, rec._target = rec._target, self.stamps
        ring.stamp(_ENTRY)

    def phase(self, phase: str) -> None:
        self.ns.append(time.perf_counter_ns())
        self._range(phase)

    def __exit__(self, exc_type, exc, tb) -> bool:
        ring = self.ring
        if self.stamps is not None:
            self.rec._target = self.prev
        if exc_type is None and ring is not None:
            slot = ring.issued
            ring.stamp(_EXIT, advance=True)
            self.ns.append(time.perf_counter_ns())
            if len(self.ns) == len(PHASES) + 1:
                self.rec._keep(self.graph, ring, slot, self.labels, self.ns)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class _NoCall:
    """The record of a call while the recorder is off: keeps nothing."""

    def __enter__(self) -> '_NoCall':
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def copy_in(self, graph, device) -> None:
        pass

    def phase(self, phase: str) -> None:
        pass


_NO_CALL = _NoCall()


class Recorder:
    """The process's flight recorder (:func:`recorder`): one stamp ring a
    device and a host ring of call records, each ``calls`` long, of calls
    of at most ``stamps`` stamps.  ``on`` is :func:`recording`'s switch.

    Read from a running server: :meth:`calls` gives the kept calls,
    oldest first, as :class:`CallRecord`; :func:`stage_ns` splits one into
    its stages' device time; :func:`idle_share` and :meth:`idle_gaps`
    say how long the card sat idle between calls, and in which host phase
    of which call each gap began."""

    def __init__(self, calls: int = RING_CALLS, stamps: int = RING_STAMPS):
        self.capacity, self.stride = calls, stamps
        self.on = True
        self.rings: dict[tuple, _Ring] = {}
        self.records: list = [None] * calls
        self.seq = 0                        # calls kept so far
        self.graphs = 0                     # graph numbers handed out
        self.labels: dict[int, tuple] = {}  # a captured graph's stamps
        self.counts: dict[int, int] = {}    # calls kept per graph
        self._target: _Stamps | None = None
        self.host_offset = time.time_ns() - time.perf_counter_ns()

    def ring(self, device: torch.device) -> _Ring:
        """``device``'s ring, made (and on a card calibrated) at first
        use: before a capture begins, never inside one."""
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        key = ((device.type, device.index) if device.type == 'cuda'
               else ('cpu', None))
        ring = self.rings.get(key)
        if ring is None:
            ring = self.rings[key] = _Ring(device, self.capacity,
                                           self.stride)
            if ring.cuda:
                ring.calibrate(self.host_offset)
        return ring

    def new_graph(self) -> int:
        self.graphs += 1
        return self.graphs - 1

    @contextlib.contextmanager
    def capturing(self, device: torch.device):
        """Around a capture on ``device`` (``utils/graphs.capture``):
        while open, :func:`stage` on this thread stamps into the graph.
        Yields the graph's number, or None with the recorder off (the
        graph then holds no stamp)."""
        if not self.on:
            yield None
            return
        target = _Stamps(self.ring(device), [])
        graph = self.new_graph()
        prev, self._target = self._target, target
        try:
            yield graph
        finally:
            self._target = prev
            self.labels[graph] = tuple(target.labels)

    def call(self) -> _Call | _NoCall:
        """A call's record, opened now: ``with rec.call() as c:`` then
        ``c.copy_in(graph, device)``, ``c.phase('launch')``,
        ``c.phase('clone')``."""
        return _Call(self) if self.on else _NO_CALL

    def eager(self, graph: int, device: torch.device,
              fn: Callable[[], Any]) -> Any:
        """``fn()`` recorded as one call whose launch is the program run
        eagerly (a graph's path on the CPU): its stages take host stamps.
        Inside another such call on this thread it is part of that call's
        launch, and keeps no record of its own."""
        target = self._target
        if (target is not None and not target.ring.cuda
                and target.thread == threading.get_ident()):
            return fn()
        with self.call() as call:
            call.copy_in(graph, device)
            call.phase('launch')
            out = fn()
            call.phase('clone')
        return out

    def _keep(self, graph: int, ring: _Ring, slot: int, labels,
              ns: list) -> None:
        index = self.counts.get(graph, 0)
        self.counts[graph] = index + 1
        self.records[self.seq % self.capacity] = (
            self.seq, graph, index, ring, slot, labels, tuple(ns))
        self.seq += 1

    def calibrate(self) -> None:
        """One more calibration point on each card (waits for the work
        queued there), for stamps to be lined up with a trace taken
        near it."""
        for ring in self.rings.values():
            if ring.cuda:
                torch.cuda.synchronize(ring.device)
                ring.calibrate(self.host_offset)

    def calls(self) -> list[CallRecord]:
        """The calls kept, oldest first.  Waits for the work queued on
        the cards and takes one more calibration point on each."""
        self.calibrate()
        stamps = {id(ring): ring.read() for ring in self.rings.values()}
        kept = sorted((r for r in self.records if r is not None),
                      key=lambda r: r[0])
        out = []
        for seq, graph, index, ring, slot, labels, ns in kept:
            if ring.issued - slot > ring.calls:
                continue                     # its slot was written since
            base = (slot % ring.calls) * ring.stride
            raw = stamps[id(ring)][base:base + _FIRST_STAGE + len(labels)]
            t = ring.to_profiler(raw, self.host_offset)
            out.append(CallRecord(
                seq, graph, index, str(ring.device),
                tuple(x + self.host_offset for x in ns),
                (('call', t[_ENTRY]),) + tuple(zip(labels, t[_FIRST_STAGE:]))
                + (('/call', t[_EXIT]),)))
        return out

    def idle_gaps(self, n: int = 10, calls: list[CallRecord] | None = None
                  ) -> list[Gap]:
        """The ``n`` longest stretches in which a device ran none of
        ``calls`` (default: :meth:`calls`), between the first call's entry
        and the last one's exit on it, each with the host phase open at
        its start: why the card sat idle."""
        calls = self.calls() if calls is None else calls
        hosts = sorted(calls, key=lambda c: c.host[0])
        starts = [c.host[0] for c in hosts]
        gaps = []
        for device in {c.device for c in calls}:
            spans = _union([(c.entry, c.exit) for c in calls
                            if c.device == device])
            gaps += [(b[0] - a[1], a[1], device)
                     for a, b in zip(spans, spans[1:])]
        gaps.sort(reverse=True)
        out = []
        for length, start, device in gaps[:n]:
            host = 'no call'
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and start < hosts[i].host[-1]:
                c = hosts[i]
                k = bisect.bisect_right(c.host, start) - 1
                host = f'{PHASES[k]} of call {c.seq}'
            out.append(Gap(start, length * 1e-9, device, host))
        return out


def _union(spans: list) -> list[tuple]:
    out: list[list] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def stage_ns(call: CallRecord) -> dict[str, list[int]]:
    """Each stage's device self time in ``call`` (ns between its stamps,
    less its inner stages'), one entry per time it ran, by name."""
    out: dict[str, list[int]] = {}
    stack: list[list] = []
    for label, t in call.stamps[1:-1]:
        if not label.startswith('/'):
            stack.append([label, t, 0])
            continue
        name, start, inner = stack.pop()
        out.setdefault(name, []).append(t - start - inner)
        if stack:
            stack[-1][2] += t - start
    return out


def idle_share(calls: list[CallRecord]) -> float | None:
    """The share of the span from the first call's entry to the last
    one's exit in which no call's [entry, exit] was open (None without a
    span)."""
    if not calls:
        return None
    spans = _union([(c.entry, c.exit) for c in calls])
    total = spans[-1][1] - spans[0][0]
    if total <= 0:
        return None
    return 1.0 - sum(e - s for s, e in spans) / total


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process's recorder."""
    return _RECORDER


class recording:
    """``recording(False)`` turns the recorder off for the process (it is
    on by default), ``recording(True)`` back on; as a context manager it
    puts the previous setting back at exit, as ``torch.set_grad_enabled``.
    Read at capture: it is part of ``utils/graphs.graph_key`` (through
    ``lever_flags``), so a graph captured without stamps is another
    graph, and calls keep no record while it is off."""

    def __init__(self, on: bool):
        self.prev = _RECORDER.on
        _RECORDER.on = bool(on)

    def __enter__(self) -> 'recording':
        return self

    def __exit__(self, *exc) -> bool:
        _RECORDER.on = self.prev
        return False


@contextlib.contextmanager
def stage(name: str):
    """A stage of a compiled program.  Inside a capture made by
    ``utils/graphs.capture`` it launches a stamp at entry and at exit,
    which each replay runs; inside a call run eagerly on the CPU it takes
    host stamps; anywhere it opens ``record_function(name)``, so an eager
    profiled run sees the stage as a range.  A stage inside another
    capture (not ``graphs.capture``'s) stamps nothing."""
    target = _RECORDER._target
    stamped = (target is not None
               and target.thread == threading.get_ident()
               and target.enter(name))
    try:
        with record_function(name):
            yield
    finally:
        if stamped:
            target.exit(name)
