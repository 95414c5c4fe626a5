"""Device ms of HRFormer's network a serving call (the grey crop to three
channels, the stem, the stages with their attention cores and fusions,
the head, the cast to f32), median over the untraced window's calls, from
the program's stage stamps (``hrnet`` and the ``attention`` and ``fuse``
inside it)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'hrnet', 'attention', 'fuse')
