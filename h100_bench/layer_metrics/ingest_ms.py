"""Host ms a serving call spends handing its frames and boxes from
pageable host memory to the card (``data/speed.to_device``: pinning a
copy, enqueueing the copy to the card), median over the untraced
window's calls, from the program's recorder spans (``ingest``)."""

from h100_bench.layer_metrics._host_spans import call_ms


def read(rec):
    return call_ms(rec, 'ingest', device=False)
