"""Channels-last peak decode in plain torch (port of the JAX package's
``experimental/nhwc_decode.py``).

The serving tail receives (B, S, S, K) heatmaps from the network.  This
decode runs the argmax and the log-Taylor step straight over the H*W axis
with K last, by reductions and gathers.  Its semantics are those of
``ops.peak.decode_heatmaps`` (row-major first-occurrence argmax, f32
inside).  ``ops.peak.decode_heatmaps_auto_nhwc`` takes it when
``ops.peak.NHWC_DECODE`` is set; otherwise the serving decode is the
peak-decode kernel.
"""

from __future__ import annotations

import torch

from esa_pose_estimation_tpu_torch.ops.peak import _taylor_offset


def argmax_peaks_nhwc(heatmaps: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W, K) -> (coords (..., K, 2) as (x, y), maxvals (..., K)),
    float32, the row-major first maximum of each map."""
    heatmaps = heatmaps.to(torch.float32)
    h, w, k = heatmaps.shape[-3:]
    flat = heatmaps.reshape(heatmaps.shape[:-3] + (h * w, k))
    idx = torch.argmax(flat, dim=-2)
    maxvals = torch.amax(flat, dim=-2)
    x = (idx % w).to(torch.float32)
    y = torch.div(idx, w, rounding_mode='floor').to(torch.float32)
    return torch.stack([x, y], dim=-1), maxvals


def taylor_refine_nhwc(heatmaps: torch.Tensor, coords: torch.Tensor,
                       eps: float = 1e-10) -> torch.Tensor:
    """Log-Taylor refinement on (..., H, W, K) maps at (..., K, 2) integer
    peaks (the semantics of ``ops.peak.taylor_refine``), in float32."""
    heatmaps = heatmaps.to(torch.float32)
    h, w, k = heatmaps.shape[-3:]
    log_hm = torch.log(torch.clamp(heatmaps, min=eps))
    flat = log_hm.reshape(log_hm.shape[:-3] + (h * w, k))
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)

    def g(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return torch.gather(flat, -2, (yy * w + xx)[..., None, :])[..., 0, :]

    return coords + _taylor_offset(g, px, py, h, w)


def decode_heatmaps_nhwc(heatmaps: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax + log-Taylor decode of (..., H, W, K) maps."""
    coords, maxvals = argmax_peaks_nhwc(heatmaps)
    return taylor_refine_nhwc(heatmaps, coords), maxvals
