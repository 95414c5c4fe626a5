"""The plain peak decode of the reference: first-occurrence argmax, then
the log-Taylor sub-pixel step of the reference's ``my_taylor``
(``inference.py:22-94``), and the confidence selection (``val.py:172-177``).

A frozen copy of the port's plain version (``ops/peak.py``), which its
decode kernel K1 is held to; it imports nothing of the port.
"""

from __future__ import annotations

import torch


def argmax_peaks(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched first-occurrence row-major argmax.

    heatmaps: (..., H, W).  Returns (coords (..., 2) float32 as (x, y),
    maxvals (...,)), computed in float32 whatever the input dtype.
    """
    heatmaps = heatmaps.to(torch.float32)
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    # torch.argmax returns the first maximal index (row-major first
    # occurrence, the np.argmax convention of the reference)
    idx = torch.argmax(flat, dim=-1)
    maxvals = torch.amax(flat, dim=-1)
    x = (idx % w).to(torch.float32)
    y = torch.div(idx, w, rounding_mode='floor').to(torch.float32)
    return torch.stack([x, y], dim=-1), maxvals


def _taylor_offset(g, px: torch.Tensor, py: torch.Tensor, h: int, w: int
                   ) -> torch.Tensor:
    """The my_taylor stencil: 5-point log-derivatives + gating.

    ``g(dy, dx)`` gathers the log-heatmap at (py+dy, px+dx).  Returns the
    gated (..., 2) subpixel offset to add to the integer peak.
    """
    c = g(0, 0)
    hx = 0.5 * (g(0, 1) - g(0, -1))
    hy = 0.5 * (g(1, 0) - g(-1, 0))
    hxx = 0.25 * (g(0, 2) - 2.0 * c + g(0, -2))
    hyy = 0.25 * (g(2, 0) - 2.0 * c + g(-2, 0))

    interior = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)
    nonzero = (hxx != 0.0) & (hyy != 0.0)
    off_x = -hx / torch.where(hxx == 0.0, 1.0, hxx)
    off_y = -hy / torch.where(hyy == 0.0, 1.0, hyy)
    in_range = (off_x < 1.0) & (off_y < 1.0)
    apply = interior & nonzero & in_range
    offset = torch.stack([off_x, off_y], dim=-1)
    return torch.where(apply[..., None], offset, 0.0)


def taylor_refine(heatmaps: torch.Tensor, coords: torch.Tensor,
                  eps: float = 1e-10) -> torch.Tensor:
    """Log-Taylor sub-pixel refinement (vectorized ``my_taylor``).

    heatmaps: (..., H, W); coords: (..., 2) float (x, y) at integer peaks.
    Returns refined coords (..., 2), in float32.
    """
    heatmaps = heatmaps.to(torch.float32)
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = torch.log(torch.clamp(heatmaps, min=eps)).reshape(
        heatmaps.shape[:-2] + (h * w,))
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)

    def g(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    return coords + _taylor_offset(g, px, py, h, w)


def decode_heatmaps(heatmaps: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax + log-Taylor decode, the plain version of the kernel.

    heatmaps: (..., H, W) -> (coords (..., 2), maxvals (...,)).
    """
    coords, maxvals = argmax_peaks(heatmaps)
    return taylor_refine(heatmaps, coords), maxvals


def select_confident(maxvals: torch.Tensor, threshold: float = 0.6,
                     min_count: int = 0) -> torch.Tensor:
    """Keypoint selection mask: {i : maxval_i > threshold} plus, if needed,
    the most confident remainder up to ``min_count`` (the reference's
    top-``large_k`` rule, val.py:172-175).  maxvals (..., K) -> bool mask."""
    above = maxvals > threshold
    if min_count <= 0:
        return above
    k = maxvals.shape[-1]
    order = torch.argsort(-maxvals, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return above | (rank < min(min_count, k))
