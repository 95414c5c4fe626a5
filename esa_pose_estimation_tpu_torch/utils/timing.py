"""Device timing by CUDA events (``chip_smoke.py`` and ``cli/mfu_experiments``).

A host clock without a synchronise measures the enqueue, not the work, so
both helpers record CUDA events around many calls and synchronise once.
They need a CUDA device.
"""

from __future__ import annotations

import torch

BF16_TC_FLOPS = 989e12     # H100 SXM bf16 dense tensor-core peak


def cuda_ms(fn, inputs: list, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn(*inputs[i % len(inputs)])`` by CUDA events;
    cycling several input copies keeps the working set above the L2."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, inputs: list, iters: int = 20
              ) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain
    and averaged, so a drift of the card's clocks hits both alike."""
    p1 = cuda_ms(plain_fn, inputs, iters)
    k1 = cuda_ms(kernel_fn, inputs, iters)
    k2 = cuda_ms(kernel_fn, inputs, iters)
    p2 = cuda_ms(plain_fn, inputs, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2
