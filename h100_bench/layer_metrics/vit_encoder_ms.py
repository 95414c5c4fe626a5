"""Device ms of ViTPose's encoder (the grey crop to three channels, the
patch embedding and positions, the blocks with their attention, the last
norm) a serving call, median over the untraced window's calls, from the
program's stage stamps (``vit_encoder`` and the ``attention`` inside
it)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'vit_encoder', 'attention')
