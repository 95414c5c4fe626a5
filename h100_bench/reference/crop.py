"""A frozen copy, for the benchmark's plain reference, of the port's
ops/crop.py (its SPEED subset).
It imports nothing of the port, so a later change to the port's code leaves
it as it is.  The original's first line:

Detector box -> square crop -> resize, as two dense interpolation products.

Port of the JAX package's ``ops/crop.py`` (reference: data_load4.py:110-166):
bbox -> centered square box x1.05 -> clamp/shift into the frame -> crop ->
edge-pad -> bilinear resize, with ``rate = out_size / crop_size``.  The
output grid is sampled directly from the full frame; edge padding falls
out of clamping the sample coordinates, and the bilinear sampling is two
f32 products with tent-weight matrices.  The box arithmetic replicates the
reference's ``int()`` truncation, including its f64 products, through a
host-computed table.
"""

from __future__ import annotations

from functools import lru_cache

import torch


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """Python int() semantics: truncate toward zero."""
    return torch.trunc(x).to(torch.int32)


@lru_cache(maxsize=8)
def _kmul_table(k: float, n: int = 4097, t_cap: int = 1 << 20
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Exact host-computed f64 behavior of ``c +- k*h`` for integer h.

    Per h: (floor(k*h), thresh) where ``thresh`` is the largest integer t
    for which the fractional part of k*h still survives the f64
    subtraction ``t - k*h < t`` (``1.05*20`` is exactly 21.0 but ``1.1*90``
    is 99.000...01, and ``500 - 55.000...01`` rounds to 445.0).
    """
    floors, threshs = [], []
    for h in range(n):
        y = k * float(h)
        m = int(y)
        floors.append(m)
        if y == float(m):
            threshs.append(0)              # exact product: no borrow ever
        else:
            f = y - m                      # the exact f64 fractional part
            lo, hi = 0, t_cap
            # largest t with (t - f) < t, monotone in t -> binary search
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if (mid - f) < mid:
                    lo = mid
                else:
                    hi = mid - 1
            threshs.append(lo)
    return tuple(floors), tuple(threshs)


@lru_cache(maxsize=8)
def _kmul_tensors(k: float, n: int, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_kmul_table` as int32 tensors on ``device``, copied once."""
    floors, threshs = _kmul_table(k, n=n)
    return (torch.tensor(floors, dtype=torch.int32, device=device),
            torch.tensor(threshs, dtype=torch.int32, device=device))


def _expand_box_int(c0: torch.Tensor, c1: torch.Tensor, half: torch.Tensor,
                    k: float, table_size: int = 4097
                    ) -> tuple[torch.Tensor, ...]:
    """``int(c +- k*half)`` with the reference's Python-float (f64)
    semantics, as integer arithmetic on the host-computed product table.
    With y = k*half = m + frac:

      int(c - y) = c - m - 1 if 1 <= (c - m) <= thresh else c - m
      int(c + y) = c + m + 1 if -thresh <= (c + m) < 0 else c + m
    """
    tbl_m, tbl_t = _kmul_tensors(float(k), max(int(table_size), 2),
                                 half.device)
    idx = torch.clamp(half, 0, tbl_m.shape[0] - 1).long()
    m = tbl_m[idx]
    thr = tbl_t[idx]

    def sub(c):
        t = c - m
        return t - ((t >= 1) & (t <= thr)).to(torch.int32)

    def add(c):
        t = c + m
        return t + ((t < 0) & (-t <= thr)).to(torch.int32)

    return sub(c0), sub(c1), add(c0), add(c1)


def adjust_bbox(bbox: torch.Tensor, img_w: int = 1920, img_h: int = 1200,
                k: float = 1.05, force_square: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Square-expand and clamp a detector box (data_load4.py:110-146).

    bbox: (..., 4) corners [x1, y1, x2, y2].  ``force_square=False`` is
    the submission-dataset variant (data_load_val.py:125-157) without the
    square-equalization step.

    Returns (origin (..., 2) int32 [x_new, y_new],
             crop_sizes (..., 2) int32 [xsize, ysize],
             size (...,) int32 -- the padded square side).
    """
    x1, y1, x2, y2 = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    c0 = _trunc_int((x1 + x2) / 2)
    c1 = _trunc_int((y1 + y2) / 2)
    half = _trunc_int(torch.maximum(x2 - x1, y2 - y1) / 2)

    x_new, y_new, w_new, h_new = _expand_box_int(
        c0, c1, half, k, table_size=max(img_w, img_h) + 2)
    if force_square:
        h_new = torch.where(w_new - x_new != h_new - y_new,
                            y_new + (w_new - x_new), h_new)
    w_new = torch.where(x_new < 0, w_new - x_new, w_new)
    x_new = torch.clamp(x_new, min=0)
    h_new = torch.where(y_new < 0, h_new - y_new, h_new)
    y_new = torch.clamp(y_new, min=0)

    over_w = w_new > img_w
    x_new = torch.where(over_w, torch.clamp(x_new + img_w - w_new, min=0),
                        x_new)
    w_new = torch.where(over_w, img_w, w_new)
    over_h = h_new > img_h
    y_new = torch.where(over_h, torch.clamp(y_new + img_h - h_new, min=0),
                        y_new)
    h_new = torch.where(over_h, img_h, h_new)

    xsize = w_new - x_new
    ysize = h_new - y_new
    size = torch.maximum(xsize, ysize)
    origin = torch.stack([x_new, y_new], dim=-1)
    crop_sizes = torch.stack([xsize, ysize], dim=-1)
    return origin, crop_sizes, size


def adjust_bbox_val(bbox: torch.Tensor, img_w: int = 1920, img_h: int = 1200,
                    k: float = 1.05
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ESAValDataSet submission crop box (data_load_val.py:125-157)."""
    return adjust_bbox(bbox, img_w, img_h, k, force_square=False)


def _interp_matrix(samples: torch.Tensor, in_size: int) -> torch.Tensor:
    """Dense bilinear interpolation matrix from (clamped) sample
    coordinates: (..., out) -> (..., out, in_size), row i holding the tent
    weights max(0, 1 - |j - samples_i|)."""
    idx = torch.arange(in_size, dtype=samples.dtype, device=samples.device)
    return torch.clamp(1.0 - (idx - samples[..., None]).abs(), min=0.0)


def crop_resize_single(image: torch.Tensor, origin: torch.Tensor,
                       crop_sizes: torch.Tensor, size: torch.Tensor,
                       out_size: int) -> torch.Tensor:
    """Bilinear-sample one square crop to (out_size, out_size[, C]):
    :func:`crop_resize_from_boxes` of a batch of one."""
    return crop_resize_from_boxes(image[None], origin[None], crop_sizes[None],
                                  size[None], out_size)[0]


def crop_resize_from_boxes(images: torch.Tensor, origin: torch.Tensor,
                           crop_sizes: torch.Tensor, size: torch.Tensor,
                           out_size: int) -> torch.Tensor:
    """Batched crop+resize from precomputed box geometry.

    images: (B, H, W) or (B, H, W, C); origin/crop_sizes: (B, 2); size:
    (B,).  cv2.resize INTER_LINEAR half-pixel convention; clamped sample
    coordinates reproduce edge padding.  Non-square crops reproduce the
    reference's swapped pad widths (``np.pad(image, ((0, size-xsize), (0,
    size-ysize)), 'edge')``, data_load4.py:151): rows are padded by the
    width deficit and columns by the height deficit.
    """
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    b, h, w, c = images.shape
    sizef = size.to(torch.float32)
    xsize = crop_sizes[:, 0:1].to(torch.float32)
    ysize = crop_sizes[:, 1:2].to(torch.float32)
    pad_w = xsize + (sizef[:, None] - ysize)   # reference's swapped pads
    pad_h = ysize + (sizef[:, None] - xsize)

    grid = (torch.arange(out_size, dtype=torch.float32,
                         device=images.device) + 0.5)[None, :]
    sx = torch.clamp(grid * (pad_w / out_size) - 0.5, min=0.0) \
        .minimum(xsize - 1.0) + origin[:, 0:1].to(torch.float32)
    sy = torch.clamp(grid * (pad_h / out_size) - 0.5, min=0.0) \
        .minimum(ysize - 1.0) + origin[:, 1:2].to(torch.float32)

    Wy = _interp_matrix(sy, h)                        # (B, out, H)
    Wx = _interp_matrix(sx, w)                        # (B, out, W)
    img = images.to(torch.float32)
    rows = torch.einsum('byh,bhwc->bywc', Wy, img)    # (B, out, W, C)
    out = torch.einsum('bxw,bywc->byxc', Wx, rows)    # (B, out, out, C)
    return out[..., 0] if squeeze else out


def crop_resize(images: torch.Tensor, bboxes: torch.Tensor, out_size: int,
                img_w: int = 1920, img_h: int = 1200, k: float = 1.05,
                force_square: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched detect->crop->resize stage.

    images: (B, H, W) or (B, H, W, C); bboxes: (B, 4) corners.
    Returns (crops (B, out, out[, C]) float32, rates (B,) float32 --
    ``out_size / crop_size``, origins (B, 2) int32 -- crop top-left).
    Keypoint transform: crop-space ``rate * (kp - origin)``; inverse
    ``pred / rate + origin``.
    """
    origin, crop_sizes, size = adjust_bbox(bboxes, img_w, img_h, k,
                                           force_square=force_square)
    crops = crop_resize_from_boxes(images, origin, crop_sizes, size, out_size)
    rates = out_size / size.to(torch.float32)
    return crops, rates, origin


def normalize(crops: torch.Tensor, mean: float = 0.449, std: float = 0.229
              ) -> torch.Tensor:
    """uint8-range crop -> normalized float (ToTensor then Normalize)."""
    return (crops / 255.0 - mean) / std
