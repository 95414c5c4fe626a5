"""The attention products' share of their roofline: the least time the
card could take for ``4 N^2 D`` FLOPs a block and frame (``q k^T`` and
``a v``; ``vit_counts.attention_flops``) over a call's frames at the dense
bf16 peak, over ``vit_attention_ms``'s device time a call.  The products
are bound by operations (N = 1,024 tokens, head dim 80)."""

from h100_bench.counts import PEAK_BF16_FLOPS
from h100_bench.layer_metrics._vit_spans import call_ms
from h100_bench.vit_counts import attention_flops


def read(rec):
    ms = call_ms(rec, 'attention')
    if not ms:
        return None
    flops = attention_flops(rec.config, rec.workload['traffic']['batch'])
    return 100.0 * flops / PEAK_BF16_FLOPS / (ms * 1e-3)
