"""Device ms of the solver stages (``ransac_epnp`` and the dual LM
``refine``) of a call of the host-ingest cell, median over the untraced
window's calls, from the program's stage stamps inside the serving
graph."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'ransac_epnp', 'refine')
