"""Device ms of the solver stages (the RANSAC-EPnP kernel, stage
``ransac_epnp``, and the dual LM, stage ``refine``) of a ViTPose serving
call, median over the untraced window's calls, from the program's stage
stamps."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'ransac_epnp', 'refine')
