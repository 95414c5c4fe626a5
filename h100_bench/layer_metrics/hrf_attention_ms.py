"""Device ms of HRFormer's attention cores (each block's windowed
``scaled_dot_product_attention`` with its relative-position bias alone, 44
a call) a serving call, median over the untraced window's calls, from the
program's stage stamps (``attention``)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'attention')
