"""Device ms of the ``refine`` stage (the dual LM) of a batch-1 serving
call, median over the
untraced window's calls, from the program's stage stamps inside the
serving graph."""

from h100_bench.layer_metrics._spans import stage_ms


def read(rec):
    return stage_ms(rec, 'refine')
