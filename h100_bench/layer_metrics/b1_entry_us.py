"""Host µs of the serving graph's entry (``utils/graphs.Graphed``): the
sum of its phases (the key and storage check, the input copies, the
launch, the output clones), mean over the untraced window's calls, from
the program's recorder."""

from h100_bench.layer_metrics._spans import entry_us


def read(rec):
    return entry_us(rec)
