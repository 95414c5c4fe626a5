"""Heatmap peak decoding with log-Taylor sub-pixel refinement (torch port).

Port of the JAX package's ``ops/peak.py`` (reference: inference.py:22-94,
``get_max_preds`` + ``my_taylor``).  :func:`decode_heatmaps` is the plain
PyTorch version of the peak-decode kernel
(``ops/kernels/peak_decode.py``, ``csrc/peak_decode.cu``); the serving
path reaches the kernel through :func:`decode_heatmaps_auto_nhwc`, or the
channels-last torch decode when ``NHWC_DECODE`` is set.
:func:`decode_heatmaps_dark` is the DARK decode (reference
inference.py:154-170), in plain torch.

Semantics match ``my_taylor``:

* heatmap floored at 1e-10 before ``log``;
* offsets only applied when ``1 < px < W-2`` and ``1 < py < H-2``;
* offsets only applied when ``hxx != 0 and hyy != 0``;
* offsets only applied when ``offset_x < 1 and offset_y < 1`` (the
  reference checks the *signed* value).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu_torch.ops.kernels.peak_decode import peak_decode


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


def decode_heatmaps_auto(heatmaps: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode (..., H, W) maps: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2:]
    # (..., H, W) -> (1, H, W, N) strided view; the kernel's wrapper makes
    # it contiguous
    nhwc = heatmaps.reshape((-1, h, w)).permute(1, 2, 0)[None]
    coords, maxvals = peak_decode(nhwc)
    return coords.reshape(lead + (2,)), maxvals.reshape(lead)


# Decode dispatch for channels-last model output: True = the reduce and
# gather torch decode (experimental/nhwc_decode.py), False = the
# peak-decode kernel.  Module-level so tests and chip_smoke.py can force
# either path.  Default False, as in the JAX package.
NHWC_DECODE: bool = False


def decode_heatmaps_auto_nhwc(heatmaps: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode channels-last model output (B, S, S, K) -> (coords (B, K, 2),
    maxvals (B, K)).  The kernel reads the network's contiguous
    channels-last output as it is, so the serving path needs no
    transpose."""
    if NHWC_DECODE:
        from esa_pose_estimation_tpu_torch.experimental.nhwc_decode import (
            decode_heatmaps_nhwc,
        )
        return decode_heatmaps_nhwc(heatmaps)
    return peak_decode(heatmaps)


def gaussian_modulate(heatmaps: torch.Tensor, kernel: int = 11
                      ) -> torch.Tensor:
    """Max-preserving Gaussian blur of (..., H, W) maps (vectorized
    ``gaussian_blur``, reference inference.py:96-110).

    cv2.GaussianBlur(k, k, sigma=0) uses sigma = 0.3*((k-1)*0.5 - 1) + 0.8
    with a zero border of (k-1)//2: a separable convolution with zero
    padding; each map is rescaled so its max is unchanged.
    """
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1.0) + 0.8
    half = (kernel - 1) // 2
    x = torch.arange(kernel, dtype=heatmaps.dtype,
                     device=heatmaps.device) - half
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape((-1, 1, h, w))
    orig_max = flat.amax(dim=(-2, -1), keepdim=True)
    blurred = F.conv2d(flat, g.reshape(1, 1, kernel, 1), padding=(half, 0))
    blurred = F.conv2d(blurred, g.reshape(1, 1, 1, kernel), padding=(0, half))
    new_max = torch.clamp(blurred.amax(dim=(-2, -1), keepdim=True), min=1e-12)
    return (blurred * (orig_max / new_max)).reshape(lead + (h, w))


def taylor_refine_hessian(heatmaps: torch.Tensor, coords: torch.Tensor,
                          eps: float = 1e-10) -> torch.Tensor:
    """Full 2x2-Hessian sub-pixel step on the log map (vectorized
    ``taylor``, reference inference.py:54-73).

    heatmaps: (..., H, W) raw maps (the log is taken here); coords (..., 2)
    at integer peaks.
    """
    h, w = heatmaps.shape[-2:]
    flat = torch.log(torch.clamp(heatmaps, min=eps)).reshape(
        heatmaps.shape[:-2] + (h * w,))
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)

    def g(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    c = g(0, 0)
    dx = 0.5 * (g(0, 1) - g(0, -1))
    dy = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = 0.25 * (g(0, 2) - 2.0 * c + g(0, -2))
    dxy = 0.25 * (g(1, 1) - g(-1, 1) - g(1, -1) + g(-1, -1))
    dyy = 0.25 * (g(2, 0) - 2.0 * c + g(-2, 0))
    det = dxx * dyy - dxy * dxy
    interior = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)
    apply = interior & (det != 0.0)
    safe_det = torch.where(det == 0.0, 1.0, det)
    # offset = -H^-1 g with H = [[dxx, dxy], [dxy, dyy]]
    off_x = -(dyy * dx - dxy * dy) / safe_det
    off_y = -(-dxy * dx + dxx * dy) / safe_det
    offset = torch.stack([off_x, off_y], dim=-1)
    return coords + torch.where(apply[..., None], offset, 0.0)


def decode_heatmaps_dark(heatmaps: torch.Tensor, kernel: int = 11
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """DARK-style decode of (..., H, W) maps: blur modulation +
    full-Hessian log-Taylor (the reference ``get_final2`` path)."""
    coords, maxvals = argmax_peaks(heatmaps)
    modulated = gaussian_modulate(heatmaps, kernel)
    return taylor_refine_hessian(modulated, coords), maxvals


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
