"""HRFormer's attention cores' share of their roofline: the least time the
card could take for a call's frames, ``max(FLOPs / 989 TFLOP/s, bytes /
3.35 TB/s)`` with the FLOPs of ``q k^T`` and ``a v`` and the bytes of q, k
and v read and o written once in bf16 at the padded token counts
(``hrf_counts.attention_flops``, ``attention_bytes``, frozen in the
configuration), over ``hrf_attention_ms``'s device time a call.  The cores
are bound by bytes (windows of 49 tokens, head dim 39)."""

from h100_bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from h100_bench.layer_metrics._vit_spans import call_ms


def read(rec):
    ms = call_ms(rec, 'attention')
    if not ms:
        return None
    cfg = rec.config
    bound = max(cfg['attention_flops_per_image'] / PEAK_BF16_FLOPS,
                cfg['attention_bytes_per_image'] / PEAK_HBM_BYTES)
    return 100.0 * bound * rec.workload['traffic']['batch'] / (ms * 1e-3)
