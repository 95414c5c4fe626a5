"""The whole training step's share of the cards' dense bf16 peak: the
forward and backward FLOPs per image of the reference network
(``counts.py``, frozen in the configuration) times the window's images/s
over all cards."""

from h100_bench.layer_metrics._common import mfu_percent


def read(rec):
    return mfu_percent(rec, rec.config['flops_train_per_image'])
