"""Device ms of a serving call's copies of its frames and boxes from
pinned host memory to the card, median over the untraced window's calls,
from the program's recorder spans (``h2d``: two stamps on the card's
stream around each copy ``data/speed.to_device`` enqueues)."""

from h100_bench.layer_metrics._host_spans import call_ms


def read(rec):
    return call_ms(rec, 'h2d', device=True)
