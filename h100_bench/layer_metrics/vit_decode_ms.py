"""Device ms of the decode stage (K1 on the 128x128 heatmaps, the
confident selection, the uncrop at the heatmaps' stride) of a ViTPose
serving call, median over the untraced window's calls, from the program's
stage stamps (``decode``)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'decode')
