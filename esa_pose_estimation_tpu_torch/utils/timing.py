"""Device timing by CUDA events (``chip_smoke.py`` and ``cli/mfu_experiments``).

A host clock without a synchronise measures the enqueue, not the work, so
the helpers record CUDA events around many calls and synchronise once;
``graph_ms`` replays the calls from a CUDA graph, so that the host's cost
per call does not count.  They need a CUDA device.
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


def graph_ms(fn, inputs: list, iters: int = 20, replays: int = 3) -> float:
    """Mean device ms per call of ``fn(*inputs[i % len(inputs)])``, with
    ``iters`` calls captured in one CUDA graph that is replayed between
    two events: the host's cost per call (Python, checks, the launch
    itself) drops out, and what is left is the device's time, gaps
    between kernels included.  Warm-up runs on the capture's side stream
    first, so one-time set-up is not captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
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


def paired_ms(kernel_fn, plain_fn, inputs: list, iters: int = 20,
              graph: bool = False) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain
    and averaged, so a drift of the card's clocks hits both alike.
    ``graph``: time by :func:`graph_ms` (device time) in place of
    :func:`cuda_ms` (eager calls, whose host cost shows when a call's
    device work is shorter than it)."""
    timer = graph_ms if graph else cuda_ms
    p1 = timer(plain_fn, inputs, iters)
    k1 = timer(kernel_fn, inputs, iters)
    k2 = timer(kernel_fn, inputs, iters)
    p2 = timer(plain_fn, inputs, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2
