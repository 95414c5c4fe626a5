"""The work HRFormer's shares divide by, from the configuration's shapes on
the benchmark's own reference (``reference/hrformer.py``), whatever
implements it; the peaks are ``counts.py``'s.

* :func:`forward_flops`: ``FlopCounterMode``'s count of one forward of the
  reference: every conv (the depthwise ones at one input channel a
  filter), every linear and both attention products, 2 per multiply-add
  (LayerNorm, GELU, softmax, BatchNorm, the bias, the resizes and the adds
  are not counted);
* :func:`attention_flops`: the attention products alone, ``4 n T C`` a
  block and frame (``q k^T`` and ``a v``: T padded tokens of width C, in
  windows of n = 49);
* :func:`attention_bytes`: the attention core's least traffic, q, k and v
  read and o written once at the padded token counts in bf16 (the bias,
  a few kB a block, is not counted).

``configs/hrformer_b_serve.json`` holds ``flops_forward_per_image``,
``attention_flops_per_image`` and ``attention_bytes_per_image``, which a
CPU test holds to these and to a hand count.
"""

from __future__ import annotations

import torch

BF16_BYTES = 2


def forward_flops(cfg: dict, batch: int = 1) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference import hrformer
    size = cfg['crop_size']
    with torch.device('meta'):
        model = hrformer.HRFormer(cfg).eval()
        x = torch.zeros((batch, size, size, cfg['in_channels']))
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model._forward(x)
    return int(fc.get_total_flops())


def _per_branch(cfg: dict):
    from h100_bench.reference import hrformer
    return zip(hrformer.blocks_per_branch(cfg), hrformer.padded_tokens(cfg),
               cfg['channels'])


def attention_flops(cfg: dict, batch: int = 1) -> int:
    n = cfg['window'] ** 2
    return batch * sum(4 * n * blocks * tokens * c
                       for blocks, tokens, c in _per_branch(cfg))


def attention_bytes(cfg: dict, batch: int = 1) -> int:
    return batch * sum(4 * BF16_BYTES * blocks * tokens * c
                       for blocks, tokens, c in _per_branch(cfg))
