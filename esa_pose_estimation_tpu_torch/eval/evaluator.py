"""Evaluation helpers (torch port of part of the JAX package's
``eval/evaluator.py``): the running mean of the SPEED evaluation loop.
The LINEMOD metrics of that module come with the LINEMOD slice."""

from __future__ import annotations


class AverageMeter:
    """Running mean/sum/count (reference: evaluation.py:14-29)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
