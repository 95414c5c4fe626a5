"""The work ViTPose's shares divide by, from the configuration's shapes
on the benchmark's own reference (``reference/vitpose.py``), whatever
implements it; the peaks are ``counts.py``'s.

* :func:`forward_flops`: ``FlopCounterMode``'s count of one forward of the
  reference: the patch conv, every linear, both attention products, the
  deconvs and the final conv, 2 per multiply-add (LayerNorm, GELU,
  softmax, BatchNorm and the adds are not counted);
* :func:`attention_flops`: the attention products alone, ``4 N^2 D`` a
  block and frame (``q k^T`` and ``a v``, N tokens of width D).

``configs/vitpose_h_serve.json`` holds ``flops_forward_per_image``, which
a CPU test holds to :func:`forward_flops` and to a hand count.
"""

from __future__ import annotations

import torch


def forward_flops(cfg: dict, batch: int = 1) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference import vitpose
    size = cfg['crop_size']
    with torch.device('meta'):
        model = vitpose.ViTPose(cfg).eval()
        x = torch.zeros((batch, size, size, cfg['in_channels']))
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model._forward(x)
    return int(fc.get_total_flops())


def attention_flops(cfg: dict, batch: int = 1) -> int:
    from h100_bench.reference import vitpose
    n = vitpose.grid(cfg) ** 2
    return 4 * n * n * cfg['embed_dim'] * cfg['depth'] * batch
