"""Device ms of ViTPose's heatmap head (two deconvs with BatchNorm and
ReLU, the final conv, the cast to f32) a serving call, median over the
untraced window's calls, from the program's stage stamps
(``vit_head``)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'vit_head')
