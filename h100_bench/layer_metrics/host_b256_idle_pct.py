"""The share of the host-ingest cell's untraced window's device span (the
first call's entry stamp to the last call's exit stamp) in which the card
ran no serving graph, from the program's recorder: the frames' copies
before each graph, and any wait for the host's pinning, count as idle."""

from h100_bench.layer_metrics._vit_spans import idle_pct


def read(rec):
    return idle_pct(rec)
