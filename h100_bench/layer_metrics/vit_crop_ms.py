"""Device ms of the crop stage (``ops/crop.crop_resize``: 64 frames to
512x512 crops) of a ViTPose serving call, median over the untraced
window's calls, from the program's stage stamps (``crop``)."""

from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    return call_ms(rec, 'crop')
