"""What several per-layer readers share.  A reader's ``read(rec)`` gets
the traced run's record: ``rec.trace`` (``trace.Trace``: the device
operations and host events of the profiled calls, their window),
``rec.images``, ``rec.steps`` and ``rec.calls`` of the profiled calls,
``rec.host_call_s`` (host seconds of each call until the program
returned, before any wait), ``rec.window_images_per_s`` (the untraced
window's images/s over all cards), ``rec.config``, ``rec.workload``,
``rec.chips``, and ``rec.live``: the program's objects, for a reader that
times a layer in a CUDA graph of its own.  It returns a number, or None
where it finds nothing to read."""

from __future__ import annotations


def mfu_percent(rec, flops_per_image: float) -> float | None:
    """The window's images/s over all cards (untraced: the tracer
    stretches a call) times the work per image, as a share of the cards'
    dense bf16 peak."""
    from h100_bench.counts import PEAK_BF16_FLOPS
    if not rec.window_images_per_s:
        return None
    return 100.0 * rec.window_images_per_s * flops_per_image / (
        PEAK_BF16_FLOPS * rec.chips)
