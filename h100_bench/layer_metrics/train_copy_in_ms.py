"""Device ms from a training call's entry stamp to its graph's first
stamp: the copies of the next 8 batches into the graph's buffers and
the steps' rates, median over the untraced window's calls, from the
program's recorder."""

from h100_bench.layer_metrics._spans import lead_ms


def read(rec):
    return lead_ms(rec)
