"""Device ms of a training step's ``backward`` stage (the gradients
zeroed, the backward), per step, median over the
untraced window's calls, from the program's stage stamps inside the
training graph."""

from h100_bench.layer_metrics._spans import stage_ms


def read(rec):
    return stage_ms(rec, 'backward')
