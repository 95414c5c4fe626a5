"""Device ms of HRFormer's fusions (each module's cross-resolution sum:
1x1 convs with bilinear upsampling, depthwise-separable downsampling, 7 a
call) a serving call, median over the untraced window's calls, from the
program's stage stamps (``fuse``)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'fuse')
