"""Host microseconds of one call into the program until it returns, before
anything waits on the card (the graph entry's storage check, input copies
and launch), mean over the calls of the run's window (untraced: the
tracer slows a graph's launch)."""


def read(rec):
    xs = rec.host_call_s
    return 1e6 * sum(xs) / len(xs) if xs else None
