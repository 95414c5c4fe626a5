"""Device ms of a training step's ``optimizer`` stage (capturable
Adam), per step, median over the
untraced window's calls, from the program's stage stamps inside the
training graph."""

from h100_bench.layer_metrics._spans import stage_ms


def read(rec):
    return stage_ms(rec, 'optimizer')
