"""The share of the HRFormer cell's untraced window's device span (the
first call's entry stamp to the last call's exit stamp) in which the card
ran no serving call, from the program's recorder: work the harness puts
between calls counts as idle."""

from h100_bench.layer_metrics._vit_spans import idle_pct


def read(rec):
    return idle_pct(rec)
