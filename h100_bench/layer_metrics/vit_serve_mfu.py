"""ViTPose's whole serving step's share of the card's dense bf16 peak:
the forward FLOPs per image of the reference (``vit_counts.py``, frozen in
the configuration) times the untraced window's images/s."""

from h100_bench.layer_metrics._common import mfu_percent


def read(rec):
    return mfu_percent(rec, rec.config['flops_forward_per_image'])
