"""K1's share of its roofline in the ViTPose cell: the least time the card
could take to read the heatmaps once and write the keypoints once (bytes
over 3.35 TB/s, at the heatmaps' size: the crop over the stride), over
the device time of the ``peak_decode_kernel`` kernels per profiled
call."""

from h100_bench.counts import PEAK_HBM_BYTES, k1_bytes


def read(rec):
    ks = rec.trace.kernels('peak_decode_kernel')
    if not ks or not rec.calls:
        return None
    seconds = sum(k.end - k.start for k in ks) * 1e-6 / rec.calls
    cfg = rec.config
    bound = k1_bytes(rec.images // rec.calls, cfg['heatmap_size'],
                     cfg['num_keypoints']) / PEAK_HBM_BYTES
    return 100.0 * bound / seconds
