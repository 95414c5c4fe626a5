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
* :class:`MultiClassPrecisionRecall` (net_utils.py:241-270).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import numpy as np
import torch


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
