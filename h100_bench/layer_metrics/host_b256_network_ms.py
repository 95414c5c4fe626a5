"""Device ms of the network stage (normalisation and ``model(x)``) of a
call of the host-ingest cell, median over the untraced window's calls,
from the program's stage stamps inside the serving graph."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'hrnet')
