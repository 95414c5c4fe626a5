"""CUDA graphs of the port's compiled programs: ``jax.jit``'s counterpart
on the card.

The JAX package runs its serving path (``pipeline.make_jitted_pipeline``),
its eval tail (``eval/eval_cache.py``) and its synthetic training segment
(``train/state.make_sharded_scan_step``) as compiled programs, one
dispatch per call.  Eagerly, the port pays a host launch per kernel
instead: about 12,000 of them in one serving call.  :class:`Graphed`
captures a function once per key into a ``torch.cuda.CUDAGraph`` and
replays it:

* **key**: every tensor input's shape, dtype and device; every other
  argument by value (a module by identity and train/eval mode); and the
  module flags read at trace time (:func:`lever_flags`), as JAX reads
  them when it traces.  A flag flipped after a capture selects another
  graph.
* **capture**: one warm-up call on a side stream (device constants made
  on first use, the kernels' one-time set-up, cuDNN's plans), then the
  capture into one memory pool shared by the live graphs of the card
  (:func:`graph_pool`), on that card's capture stream
  (:func:`capture_stream`), with the card as the current device: a
  process may capture on each of its cards.  A capture that fails
  raises; nothing falls back to eager on the card.
* **replay**: the tensor inputs are copied into the graph's static
  buffers, the graph replays, and the outputs are cloned, since JAX
  returns fresh arrays and callers keep outputs across calls.  Cloning at
  once also keeps the shared pool safe: no graph's output outlives the
  next replay of another.  Each call is one record of the process's
  recorder (``obs/profiling.Recorder``): its host phases ``check`` (the
  key, the lookup or capture, the storage check), ``copy_in``, ``launch``
  and ``clone``, and its device stamps, around the call and at the
  stages (``obs/profiling.stage``) that the capture stamped.
* **CPU tensors** run the function eagerly: the caller asked for the CPU,
  and CUDA graphs exist only on the card.  The call is recorded all the
  same, its launch being the eager run and its stages host stamps.

A captured function draws nothing at random (the caller draws before the
call and passes the draws in, as JAX passes its ``key``), reads nothing
back to the host, and copies nothing from host memory.  It reads each
module's parameters and buffers where they lie at capture: they may
change in place (an optimizer step, ``load_state_dict``), but not be
replaced.  Each capture keeps the storage pointers of the tensors it
reads in place (:func:`storage_pointers`: a module's parameters and
buffers; a training graph's gradients and optimizer state too) and every replay compares them with
the current ones first (:func:`check_pointers`): a replaced tensor
(``m.to(dtype)``, ``load_state_dict(..., assign=True)``) raises rather
than replay against freed memory.

The kernels' launch counts (``peak_decode.launches`` and the others)
follow the device: the capture launches nothing, so the counts it added
are taken back, and each replay adds them again.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Iterable, NamedTuple

import torch
from torch import nn

from esa_pose_estimation_tpu_torch.obs import profiling

_POOLS: dict[int, tuple] = {}
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def _index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream captures on ``device`` run on, one per card:
    ``torch.cuda.graph``'s own default is one stream for the process, made
    on the card of its first capture, and a capture on another card
    through it would record nothing of that card's work."""
    idx = _index(device)
    stream = _CAPTURE_STREAMS.get(idx)
    if stream is None:
        stream = _CAPTURE_STREAMS[idx] = torch.cuda.Stream(idx)
    return stream


def graph_pool(device: torch.device):
    """The memory pool every live graph of this process captures into,
    one per card: graphs replay one at a time on one stream, and each
    caller clones a replay's outputs before the next replay.  A pool dies
    with the last graph that used it; the next capture starts another."""
    idx = _index(device)
    pool, live = _POOLS.get(idx, (None, None))
    if not live:
        pool, live = _POOLS[idx] = (torch.cuda.graph_pool_handle(),
                                    weakref.WeakSet())
    return pool, live


def lever_flags() -> tuple[tuple[str, bool], ...]:
    """The module flags the serving path reads while it runs, which JAX
    reads at trace time, and whether the recorder stamps the stages
    (``obs/profiling.recording``): part of every key."""
    from esa_pose_estimation_tpu_torch.models import hrnet, layers
    from esa_pose_estimation_tpu_torch.ops import peak
    return (('FUSED_CBAM', layers.FUSED_CBAM),
            ('INT8_SERVING', layers.INT8_SERVING),
            ('MERGED_FUSE', hrnet.MERGED_FUSE),
            ('NHWC_DECODE', peak.NHWC_DECODE),
            ('RECORDING', profiling.recorder().on))


def _freeze(x):
    if isinstance(x, torch.Tensor):
        return ('tensor', tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, nn.Module):
        return ('module', id(x), x.training)
    if isinstance(x, torch.Generator):
        raise TypeError('a graph cannot draw: draw before the call and pass '
                        'the draws in')
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_freeze(v) for v in x))
    if isinstance(x, dict):
        return ('dict', tuple((k, _freeze(x[k])) for k in sorted(x)))
    hash(x)                     # an unhashable value cannot key a graph
    return ('value', type(x).__name__, x)


def graph_key(args: tuple, kwargs: dict) -> tuple:
    """The key of one call: positional and keyword arguments frozen
    (tensors by shape, dtype and device; other values as they are), and
    :func:`lever_flags`."""
    return (_freeze(tuple(args)), _freeze(dict(kwargs)), lever_flags())


def tree_map(fn, x):
    """``fn`` on every tensor of nested tuples (named ones too), lists and
    dicts; other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def _modules_of(x) -> list[nn.Module]:
    """The modules among a call's arguments (nested tuples, lists and
    dicts)."""
    if isinstance(x, nn.Module):
        return [x]
    if isinstance(x, (tuple, list)):
        return [m for v in x for m in _modules_of(v)]
    if isinstance(x, dict):
        return [m for v in x.values() for m in _modules_of(v)]
    return []


def tensors_of(x) -> list[torch.Tensor]:
    """The tensors of a tree, in :func:`tree_map`'s order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, x)
    return out


def _counts() -> tuple[tuple[str, object, str], ...]:
    """What a replay adds to, as (label, wrapper, attribute): each hand-
    written kernel's launches, attention's calls and its query tokens."""
    from esa_pose_estimation_tpu_torch.experimental.branch_chain import (
        branch_chain,
    )
    from esa_pose_estimation_tpu_torch.experimental.cbam_fuse import (
        fused_cbam,
    )
    from esa_pose_estimation_tpu_torch.models.vitpose import attention
    from esa_pose_estimation_tpu_torch.ops.kernels.lm_dual import refine_pose
    from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import (
        peak_decode,
    )
    from esa_pose_estimation_tpu_torch.ops.kernels.ransac_epnp import (
        ransac_epnp,
    )
    return (('k1', peak_decode, 'launches'), ('k2', fused_cbam, 'launches'),
            ('k3', branch_chain, 'launches'),
            ('ransac_epnp', ransac_epnp, 'launches'),
            ('lm_dual', refine_pose, 'launches'),
            ('sdpa', attention, 'launches'),
            ('sdpa_tokens', attention, 'tokens'))


def tensor_reader(modules: Iterable[nn.Module], grads: bool = False
                  ) -> Callable[[], list]:
    """A function that lists the parameters and buffers of ``modules`` as
    they stand when it is called, and with ``grads`` the parameters'
    gradients (None where there is none).  It reads the submodules' own
    dicts, found once, so it is cheap enough to run before every replay,
    and sees a parameter that was replaced, not only one whose data was."""
    subs = {id(m): m for root in modules for m in root.modules()}.values()
    params = [m._parameters for m in subs if m._parameters]
    buffers = [m._buffers for m in subs if m._buffers]

    def read() -> list:
        ps = [p for d in params for p in d.values() if p is not None]
        out = ps + [b for d in buffers for b in d.values() if b is not None]
        if grads:
            out += [p.grad for p in ps]
        return out
    return read


def storage_pointers(tensors: Iterable) -> tuple[int, ...]:
    """The ``data_ptr`` of each tensor, 0 for None."""
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def check_pointers(recorded: tuple[int, ...], current: tuple[int, ...]
                   ) -> None:
    """Raise unless ``current`` equals the pointers recorded at capture:
    a graph replays against the storage it captured, so a tensor that was
    replaced since (not written in place) would be read or written where
    it no longer lies."""
    if recorded == current:
        return
    moved = ([i for i, (a, b) in enumerate(zip(recorded, current)) if a != b]
             if len(recorded) == len(current) else [])
    raise RuntimeError(
        f'a CUDA graph reads {len(recorded)} tensors where they lay at '
        f'capture, and {len(moved) or "some"} of them were replaced since '
        f'(positions {moved[:8]}; {len(current)} now): change parameters, '
        f'buffers and optimizer state in place, or capture a new graph')


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    outputs: object            # the graph's static outputs
    launches: dict[str, int]   # counts added per replay, by _counts()' label
    seconds: float             # the capture's host time
    pool_bytes: int            # memory the capture added to the pool
    reads: Callable[[], list]  # the tensors the graph reads in place
    pointers: tuple[int, ...]  # their storage at capture
    graph_id: int | None       # the recorder's number (None: no stamps)


def capture(fn: Callable[[], object], device: torch.device,
            reads: Callable[[], list] = list) -> Captured:
    """Capture ``fn()`` on ``device`` into the shared pool.  The caller has
    warmed ``fn`` up; an error inside the capture raises.  ``reads()``
    lists the tensors outside the graph's inputs that it reads or writes
    in place (:func:`tensor_reader`), which every replay checks first
    (:func:`check`).  The recorder's stages inside ``fn`` stamp into the graph
    (``obs/profiling.stage``; its ring is made before the capture)."""
    counters = _counts()
    before = [getattr(c, n) for _, c, n in counters]
    with profiling.recorder().capturing(device) as graph_id:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        pool, live = graph_pool(device)
        # thread_local: a loader thread's own CUDA calls stay legal
        # meanwhile
        with torch.cuda.graph(graph, pool=pool,
                              stream=capture_stream(device),
                              capture_error_mode='thread_local'):
            outputs = fn()
    live.add(graph)
    seconds = time.perf_counter() - t0
    launches = {label: getattr(c, n) - b
                for (label, c, n), b in zip(counters, before)}
    for (_, c, n), b in zip(counters, before):
        setattr(c, n, b)                # the capture launched nothing
    return Captured(graph, outputs, launches, seconds,
                    torch.cuda.memory_reserved(device) - reserved, reads,
                    storage_pointers(reads()), graph_id)


def check(cap: Captured) -> None:
    """Raise unless ``cap``'s tensors lie where they lay at capture
    (:func:`check_pointers`): what every replay does first."""
    check_pointers(cap.pointers, storage_pointers(cap.reads()))


def launch(cap: Captured) -> None:
    """Replay ``cap`` (checked by :func:`check`); the launch counts
    follow."""
    cap.graph.replay()
    for label, c, n in _counts():
        setattr(c, n, getattr(c, n) + cap.launches[label])


def warm_up(fn: Callable[[], object], device: torch.device) -> None:
    """One call of ``fn()`` on a side stream, as a capture wants it (on
    the CPU, which has no streams, the call alone)."""
    if torch.device(device).type != 'cuda':
        fn()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


class Graphed:
    """``fn`` as one CUDA graph per :func:`graph_key` (see the module's
    docstring).  ``entries`` maps each key to its :class:`Captured`, with
    the static arguments the graph reads."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.entries: dict[tuple, tuple[Captured, tuple, dict]] = {}
        self.eager_id: int | None = None

    def __call__(self, *args, **kwargs):
        rec = profiling.recorder()
        inputs = tensors_of((args, kwargs))
        if not inputs or inputs[0].device.type != 'cuda':
            if self.eager_id is None:
                self.eager_id = rec.new_graph()
            return rec.eager(
                self.eager_id,
                inputs[0].device if inputs else torch.device('cpu'),
                lambda: self.fn(*args, **kwargs))
        with rec.call() as call:
            key = graph_key(args, kwargs)
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = self._capture(args, kwargs,
                                                          inputs[0].device)
            cap, s_args, s_kwargs = entry
            check(cap)
            call.copy_in(cap.graph_id, inputs[0].device)
            for buf, t in zip(tensors_of((s_args, s_kwargs)), inputs):
                buf.copy_(t)
            call.phase('launch')
            launch(cap)
            call.phase('clone')
            out = tree_map(torch.clone, cap.outputs)
        return out

    def _capture(self, args, kwargs, device):
        s_args, s_kwargs = tree_map(torch.clone, (args, kwargs))
        modules = _modules_of((args, kwargs))
        with torch.cuda.device(device):
            warm_up(lambda: self.fn(*s_args, **s_kwargs), device)
            cap = capture(lambda: self.fn(*s_args, **s_kwargs), device,
                          tensor_reader(modules))
        return cap, s_args, s_kwargs

    def stats(self) -> list[dict]:
        """Per graph: capture seconds, pool bytes, what a replay adds to
        each of :func:`_counts` (kernel launches, attention's calls and
        tokens)."""
        return [{'seconds': c.seconds, 'pool_bytes': c.pool_bytes,
                 'launches': dict(c.launches)}
                for c, _, _ in self.entries.values()]
