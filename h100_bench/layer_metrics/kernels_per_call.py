"""Kernels the card ran per profiled call (the serving graph's replay),
by the profiler."""


def read(rec):
    if not rec.calls:
        return None
    n = len(rec.trace.kernels())
    return n / rec.calls if n else None
