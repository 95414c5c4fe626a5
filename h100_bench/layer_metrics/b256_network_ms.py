"""Device ms of the network stage (normalisation and ``model(x)``) of a
batch-256 serving call, median over the
untraced window's calls, from the program's stage stamps inside the
serving graph."""

from h100_bench.layer_metrics._spans import stage_ms


def read(rec):
    return stage_ms(rec, 'hrnet')
