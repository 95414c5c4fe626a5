"""Train-time augmentation on the device (torch port of the parts of the
JAX package's ``data/augment.py`` that keypoint and LINEMOD training use).

* :func:`color_jitter` — ``ColorJitter(0.1, 0.1, 0.05, 0.05)`` on grayscale
  crops (data_load4.py:78-83): brightness and contrast in a random order
  per sample (saturation and hue are identities on one channel);
* :func:`affine_sample` / :func:`rotation_matrices` — batched inverse-warp
  sampling, used by the crop-space rotation of ``data/pipeline.py``;
* :func:`perturb_capture` — exposure gain/offset, then the reference
  augmentation library's gaussian-noise-or-motion-blur coin
  (augmentation.py:207-233), the ``--augment-photo`` transform and the
  ``cli/eval_synthetic --perturb`` probe;
* the PVNet instance augmentations of real-LINEMOD training
  (augmentation.py:45-315, linemod_dataset.py:256-293):
  :func:`random_occlusion`, :func:`random_rotate`,
  :func:`random_crop_resize_v2` (over :func:`crop_resize_instance_v2`,
  :func:`compute_resize_range` and :func:`window_shift`) and
  :func:`random_flip`, each batched, keypoints moved alongside.

Every random transform is split in two: ``draw_*(generator, ...)`` draws
its random numbers from an explicit ``torch.Generator`` into a dict, and
the transform itself is a deterministic function of the images and that
dict.  A test injects the JAX package's draws through the same dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def _per_sample(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) broadcasting over ``ndim``-d images."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def draw_color_jitter(generator: torch.Generator, batch: int,
                      brightness: float = 0.1, contrast: float = 0.1,
                      device=None) -> dict:
    """Per sample: brightness and contrast factors, and which comes first."""
    return {
        'brightness': _uniform(generator, (batch,), 1.0 - brightness,
                               1.0 + brightness, device),
        'contrast': _uniform(generator, (batch,), 1.0 - contrast,
                             1.0 + contrast, device),
        'order': torch.rand((batch,), generator=generator,
                            device=device) < 0.5,
    }


def color_jitter(crops: torch.Tensor, draws: dict) -> torch.Tensor:
    """crops (B, H, W) or (B, H, W, C) in [0, 255]."""
    nd = crops.dim()
    bf = _per_sample(draws['brightness'], nd)
    cf = _per_sample(draws['contrast'], nd)

    def apply_brightness(x):
        return torch.clamp(x * bf, 0.0, 255.0)

    def apply_contrast(x):
        mean = x.mean(dim=tuple(range(1, nd)), keepdim=True)
        return torch.clamp((x - mean) * cf + mean, 0.0, 255.0)

    a = apply_contrast(apply_brightness(crops))
    b = apply_brightness(apply_contrast(crops))
    return torch.where(_per_sample(draws['order'], nd), a, b)


def affine_sample(images: torch.Tensor, matrices: torch.Tensor,
                  fill: float = 0.0, nearest: bool = False) -> torch.Tensor:
    """Bilinear (or, with ``nearest``, round-to-nearest) inverse warp of
    (B, H, W) or (B, H, W, C) images by per-sample (B, 2, 3) affines
    mapping OUTPUT pixel (x, y, 1) to input coordinates; out-of-bounds
    samples take ``fill``."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    b, h, w, c = images.shape
    dev = images.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    M = matrices[:, :, :, None, None]
    sx = M[:, 0, 0] * xs + M[:, 0, 1] * ys + M[:, 0, 2]
    sy = M[:, 1, 0] * xs + M[:, 1, 1] * ys + M[:, 1, 2]
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    flat = images.reshape(b, h * w, c)
    if nearest:
        xi = torch.clamp(torch.round(sx).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.round(sy).to(torch.int64), 0, h - 1)
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        out = torch.gather(flat, 1, idx).reshape(b, h, w, c)
        out = torch.where(inside[..., None], out, fill)
        return out[..., 0] if squeeze else out
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def gat(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    out = (gat(y0, x0) * (1 - fx) * (1 - fy)
           + gat(y0, x1) * fx * (1 - fy)
           + gat(y1, x0) * (1 - fx) * fy
           + gat(y1, x1) * fx * fy)
    out = torch.where(inside[..., None], out, fill)
    return out[..., 0] if squeeze else out


def rotation_matrices(angles_deg: torch.Tensor,
                      centers: torch.Tensor) -> torch.Tensor:
    """Output->input affines rotating by -angle about per-sample centers:
    angles (B,) degrees, centers (B, 2) -> (B, 2, 3)."""
    th = torch.deg2rad(angles_deg)
    c, s = torch.cos(th), torch.sin(th)
    cx, cy = centers[:, 0], centers[:, 1]
    # inverse rotation: src = R^T (dst - c) + c
    m00, m01 = c, s
    m10, m11 = -s, c
    tx = cx - (m00 * cx + m01 * cy)
    ty = cy - (m10 * cx + m11 * cy)
    return torch.stack([torch.stack([m00, m01, tx], dim=-1),
                        torch.stack([m10, m11, ty], dim=-1)], dim=-2)


def add_gaussian_noise(images: torch.Tensor, noise: torch.Tensor
                       ) -> torch.Tensor:
    """augmentation.py:212-221, gaussian branch: one (B, H, W) noise field
    repeated across channels, clipped, truncated as ``.astype(np.uint8)``."""
    if images.dim() == 4:
        noise = noise[..., None]
    return torch.trunc(torch.clamp(images.to(torch.float32) + noise,
                                   0.0, 255.0))


def motion_blur(images: torch.Tensor, sizes: torch.Tensor,
                horizontal: torch.Tensor, max_size: int = 15
                ) -> torch.Tensor:
    """augmentation.py:222-232, motion-blur branch, batched: a per-sample
    box kernel of odd ``sizes`` (<= max_size) along x (``horizontal``) or
    y, reflect-101 edges (cv2.filter2D's default), rounded as cv2 rounds on
    uint8.  One conv group per sample and channel."""
    squeeze = images.dim() == 3
    imgs = images[:, None] if squeeze else images.permute(0, 3, 1, 2)
    b, c, h, w = imgs.shape
    half = max_size // 2
    dev = images.device
    taps = torch.arange(max_size, dtype=torch.float32, device=dev) - half
    sz = sizes.to(torch.float32)
    win = taps.abs()[None, :] <= ((sz - 1.0) / 2.0)[:, None]
    k1d = win.to(torch.float32) / sz[:, None]
    kx = k1d[:, None, None, :]                        # (B, 1, 1, T)
    ky = k1d[:, None, :, None]                        # (B, 1, T, 1)
    kernel = torch.where(horizontal[:, None, None, None],
                         kx * (taps[:, None] == 0.0),
                         ky * (taps[None, :] == 0.0))  # (B, 1, T, T)
    flat = F.pad(imgs.reshape(1, b * c, h, w).to(torch.float32),
                 (half, half, half, half), mode='reflect')
    out = F.conv2d(flat, kernel.repeat_interleave(c, dim=0), groups=b * c)
    out = torch.round(out.reshape(b, c, h, w))
    return out[:, 0] if squeeze else out.permute(0, 2, 3, 1)


def draw_add_noise(generator: torch.Generator, batch: int, height: int,
                   width: int, device=None) -> dict:
    """The noise-or-blur coin's draws: a gaussian coin (p 0.9), the noise
    variance U[0, 0.3] * 256, a standard-normal field, a blur size from
    {3, 5, 7, 9, 11, 15} and its direction."""
    idx = torch.randint(0, 6, (batch,), generator=generator, device=device)
    # the size table, computed on the device (no host copy per batch)
    size = torch.where(idx == 5, 15, 2 * idx + 3).to(torch.int32)
    return {
        'gaussian': torch.rand((batch,), generator=generator,
                               device=device) < 0.9,
        'var': torch.rand((batch,), generator=generator, device=device)
        * 0.3 * 256.0,
        'normal': torch.randn((batch, height, width), generator=generator,
                              device=device),
        'size': size,
        'horizontal': torch.rand((batch,), generator=generator,
                                 device=device) < 0.5,
    }


def random_add_noise(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """augmentation.py:207-233 ``add_noise``, per sample and batched: 90%
    gaussian noise, else a motion blur (:func:`draw_add_noise`)."""
    noise = torch.sqrt(draws['var'])[:, None, None] * draws['normal']
    noisy = add_gaussian_noise(images, noise)
    blurred = motion_blur(images.to(torch.float32), draws['size'],
                          draws['horizontal'])
    return torch.where(_per_sample(draws['gaussian'], images.dim()), noisy,
                       blurred)


def draw_perturb(generator: torch.Generator, batch: int, height: int,
                 width: int, gain_range: tuple[float, float] = (0.6, 1.4),
                 offset_range: tuple[float, float] = (-25.0, 25.0),
                 device=None) -> dict:
    """:func:`perturb_capture`'s draws: exposure gain and offset per
    sample, then the noise-or-blur draws."""
    return {'gain': _uniform(generator, (batch,), *gain_range, device),
            'offset': _uniform(generator, (batch,), *offset_range, device),
            **draw_add_noise(generator, batch, height, width, device)}


def perturb_capture(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """Capture-condition perturbation of [0, 255] imagery (B, H, W[, C]):
    per-sample exposure (gain, offset), clipped, then
    :func:`random_add_noise`.  The same transform is the training
    regulariser (``cli/train --augment-photo``) and the robustness probe
    (``cli/eval_synthetic --perturb``)."""
    nd = images.dim()
    f = torch.clamp(images.to(torch.float32) * _per_sample(draws['gain'], nd)
                    + _per_sample(draws['offset'], nd), 0.0, 255.0)
    return random_add_noise(f, draws)


# ---------------------------------------------------------------------------
# PVNet/LINEMOD instance augmentations (augmentation.py:45-315), batched
# ---------------------------------------------------------------------------

def _axes(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """x (1, 1, W) and y (1, H, 1) pixel coordinates."""
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    return xs, ys


def draw_occlusion(generator: torch.Generator, batch: int, height: int,
                   width: int, max_frac: float = 0.3, device=None) -> dict:
    """The rectangle of :func:`random_occlusion`: its centre (uniform over
    the crop) and half sides (uniform in [2, side * max_frac / 2])."""
    return {'cx': _uniform(generator, (batch,), 0.0, width - 1.0, device),
            'cy': _uniform(generator, (batch,), 0.0, height - 1.0, device),
            'half': torch.stack([
                _uniform(generator, (batch,), 2.0, width * max_frac / 2.0,
                         device),
                _uniform(generator, (batch,), 2.0, height * max_frac / 2.0,
                         device)], dim=-1)}


def random_occlusion(masks: torch.Tensor, draws: dict) -> torch.Tensor:
    """Zero a rectangle of each mask (augmentation.py mask_out_instance):
    masks (B, H, W)."""
    b, h, w = masks.shape
    xs, ys = _axes(h, w, masks.device)
    inside = (((xs - draws['cx'][:, None, None]).abs()
               < draws['half'][:, 0, None, None])
              & ((ys - draws['cy'][:, None, None]).abs()
                 < draws['half'][:, 1, None, None]))
    return torch.where(inside, 0.0, masks)


def draw_rotate(generator: torch.Generator, batch: int,
                max_deg: float = 30.0, device=None) -> dict:
    """The angle of :func:`random_rotate`, uniform in +-max_deg."""
    return {'angle': _uniform(generator, (batch,), -max_deg, max_deg,
                              device)}


def random_rotate(images: torch.Tensor, masks: torch.Tensor,
                  keypoints: torch.Tensor, draws: dict
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Instance rotation about the mask centroid (augmentation.py
    rotate_instance): images (B, H, W[, C]) bilinear, masks (B, H, W)
    nearest, keypoints (B, K, 2) forward-rotated."""
    angles = draws['angle']
    xs, ys = _axes(masks.shape[1], masks.shape[2], masks.device)
    msum = torch.clamp(masks.sum((1, 2)), min=1.0)
    centers = torch.stack([(masks * xs).sum((1, 2)) / msum,
                           (masks * ys).sum((1, 2)) / msum], dim=-1)
    M = rotation_matrices(angles, centers)
    out_img = affine_sample(images, M)
    out_mask = affine_sample(masks, M, nearest=True)
    # forward-transform the keypoints: dst = R (kp - c) + c
    th = torch.deg2rad(angles)
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    rel = keypoints - centers[:, None, :]
    out_kp = torch.stack([c * rel[..., 0] - s * rel[..., 1],
                          s * rel[..., 0] + c * rel[..., 1]], dim=-1) \
        + centers[:, None, :]
    return out_img, out_mask, out_kp


def draw_flip(generator: torch.Generator, batch: int, device=None) -> dict:
    """The coin of :func:`random_flip` (p 0.5)."""
    return {'flip': torch.rand((batch,), generator=generator,
                               device=device) < 0.5}


def random_flip(images: torch.Tensor, masks: torch.Tensor,
                keypoints: torch.Tensor, draws: dict
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample horizontal flip (augmentation.py flip)."""
    do = draws['flip']
    w = masks.shape[2]
    images = torch.where(_per_sample(do, images.dim()),
                         torch.flip(images, dims=(2,)), images)
    masks = torch.where(do[:, None, None], torch.flip(masks, dims=(2,)),
                        masks)
    kp_flip = torch.stack([w - 1 - keypoints[..., 0], keypoints[..., 1]],
                          dim=-1)
    return images, masks, torch.where(do[:, None, None], kp_flip, keypoints)


def _tent_matrix(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """cv2 INTER_LINEAR weights (B, out) -> (B, out, in); taps outside
    [0, in) have no column, i.e. zero padding."""
    idx = torch.arange(in_size, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - (idx - coords[..., None]).abs(), min=0.0)


def _nearest_matrix(idx: torch.Tensor, valid: torch.Tensor,
                    in_size: int) -> torch.Tensor:
    """cv2 INTER_NEAREST one-hot rows (B, out) -> (B, out, in); rows not
    ``valid`` are zero (padding)."""
    cols = torch.arange(in_size, dtype=idx.dtype, device=idx.device)
    onehot = cols == torch.clamp(idx, 0, in_size - 1)[..., None]
    return (onehot & valid[..., None]).to(torch.float32)


def _apply_separable(images: torch.Tensor, Wy: torch.Tensor,
                     Wx: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, C]) x row and column matrices -> (B, out_h, out_w[, C])."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    rows = torch.einsum('byh,bhwc->bywc', Wy, images.to(torch.float32))
    out = torch.einsum('bxw,bywc->byxc', Wx, rows)
    return out[..., 0] if squeeze else out


def window_shift(images: torch.Tensor, offsets: torch.Tensor, out_h: int,
                 out_w: int) -> torch.Tensor:
    """out[y, x] = in[y + dy, x + dx], zero outside: the integer-window
    core of crop_or_padding_to_fixed_size(_instance)
    (augmentation.py:118-185).  offsets (B, 2) [dy, dx]."""
    h, w = images.shape[1], images.shape[2]
    dev = images.device
    oy = torch.arange(out_h, dtype=torch.int64, device=dev)[None, :] \
        + offsets[:, 0:1].to(torch.int64)
    ox = torch.arange(out_w, dtype=torch.int64, device=dev)[None, :] \
        + offsets[:, 1:2].to(torch.int64)
    return _apply_separable(images,
                            _nearest_matrix(oy, (oy >= 0) & (oy < h), h),
                            _nearest_matrix(ox, (ox >= 0) & (ox < w), w))


def fixed_size_offsets_dynamic(in_h: torch.Tensor, in_w: torch.Tensor,
                               th: int, tw: int, hbeg: torch.Tensor,
                               wbeg: torch.Tensor) -> torch.Tensor:
    """The crop_or_padding_to_fixed_size offset rule (augmentation.py:
    160-185) for per-sample input extents: crop at the begin when the
    target is smaller, centre-pad (begin ignored) otherwise.  -> (B, 2)
    int32 [dy, dx]."""
    dy = torch.where(th >= in_h, -torch.div(th - in_h, 2,
                                            rounding_mode='floor'), hbeg)
    dx = torch.where(tw >= in_w, -torch.div(tw - in_w, 2,
                                            rounding_mode='floor'), wbeg)
    return torch.stack([dy, dx], dim=-1).to(torch.int32)


def crop_resize_instance_v2(images: torch.Tensor, masks: torch.Tensor,
                            keypoints: torch.Tensor,
                            resize_ratio: torch.Tensor,
                            do_resize: torch.Tensor, hbeg: torch.Tensor,
                            wbeg: torch.Tensor, out_h: int, out_w: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Deterministic core of augmentation.py:281-313: resize the whole
    image by r (where ``do_resize``), then crop or centre-pad to (out_h,
    out_w), both in one separable resample.  hbeg/wbeg are begins in the
    resized frame.  Image: cv2 half-pixel taps clamped to the source,
    zero outside the resized extent; mask: the nearest floor rule;
    keypoints: kp * r - offset."""
    h, w = images.shape[1], images.shape[2]
    r = torch.where(do_resize, resize_ratio, 1.0)
    rh = torch.trunc(h * r).to(torch.int32)       # resized extents, int()
    rw = torch.trunc(w * r).to(torch.int32)
    off = fixed_size_offsets_dynamic(rh, rw, out_h, out_w, hbeg, wbeg)

    dev = images.device
    rhf = rh.to(torch.float32)[:, None]
    rwf = rw.to(torch.float32)[:, None]
    gy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :]
    gx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    iy = gy + off[:, 0:1].to(torch.float32)
    ix = gx + off[:, 1:2].to(torch.float32)
    vy = (iy >= 0) & (iy <= rhf - 1)
    vx = (ix >= 0) & (ix <= rwf - 1)
    sy = torch.clamp((iy + 0.5) * (h / rhf) - 0.5, 0.0, h - 1.0)
    sx = torch.clamp((ix + 0.5) * (w / rwf) - 0.5, 0.0, w - 1.0)
    img = _apply_separable(images, _tent_matrix(sy, h) * vy[..., None],
                           _tent_matrix(sx, w) * vx[..., None])

    ny = torch.floor(iy * (h / rhf))
    nx = torch.floor(ix * (w / rwf))
    msk = _apply_separable(
        masks,
        _nearest_matrix(ny.to(torch.int64), vy & (ny >= 0) & (ny < h), h),
        _nearest_matrix(nx.to(torch.int64), vx & (nx >= 0) & (nx < w), w))
    kp = keypoints * r[:, None, None].to(keypoints.dtype) \
        - off.flip(-1)[:, None, :].to(keypoints.dtype)
    return img, msk, kp


def _fg_extent(masks: torch.Tensor):
    """Per sample: (any row, any column, first/last row, first/last
    column) of the foreground, +-2^30 where empty."""
    b, h, w = masks.shape
    fg = masks > 0
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    any_y = fg.any(dim=2)
    any_x = fg.any(dim=1)
    big = float(1 << 30)
    return (any_y,
            torch.where(any_y, ys, big).amin(1),
            torch.where(any_y, ys, -big).amax(1),
            torch.where(any_x, xs, big).amin(1),
            torch.where(any_x, xs, -big).amax(1))


def compute_resize_range(masks: torch.Tensor, hmin: float, hmax: float,
                         wmin: float, wmax: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """augmentation.py:235-247: per-sample [rmin, rmax] keeping the
    foreground extent within the pixel box; [1, 1] for empty masks."""
    any_y, y0, y1, x0, x1 = _fg_extent(masks)
    ylen, xlen = y1 - y0, x1 - x0
    ok = any_y.any(dim=1) & (xlen > 0) & (ylen > 0)
    xlen = torch.clamp(xlen, min=1.0)
    ylen = torch.clamp(ylen, min=1.0)
    rmin = torch.maximum(wmin / xlen, hmin / ylen)
    rmax = torch.minimum(wmax / xlen, hmax / ylen)
    return torch.where(ok, rmin, 1.0), torch.where(ok, rmax, 1.0)


def draw_crop_resize_v2(generator: torch.Generator, batch: int,
                        device=None) -> dict:
    """The uniforms of :func:`random_crop_resize_v2`: the 80% resize coin,
    the ratio within its range, the two window begins."""
    u = torch.rand((4, batch), generator=generator, device=device)
    return {'do': u[0] < 0.8, 'u_r': u[1], 'u_h': u[2], 'u_w': u[3]}


def crop_resize_v2_window(masks: torch.Tensor, draws: dict, out_h: int,
                          out_w: int, overlap_ratio: float = 0.5,
                          hmin: float = 30.0, hmax: float = 135.0,
                          wmin: float = 30.0, wmax: float = 130.0
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The sampled geometry of :func:`random_crop_resize_v2`: (r (B,), 1
    where the coin says no resize; hbeg, wbeg (B,) int32 window begins
    overlapping the instance, from the source mask's box scaled by r)."""
    b, h, w = masks.shape
    rlo, rhi = compute_resize_range(masks, hmin, hmax, wmin, wmax)
    r = torch.where(draws['do'], draws['u_r'] * (rhi - rlo) + rlo, 1.0)
    _, y0, y1, x0, x1 = _fg_extent(masks)
    hmin_i, hmax_i = y0 * r, y1 * r
    wmin_i, wmax_i = x0 * r, x1 * r
    rh = torch.trunc(h * r)
    rw = torch.trunc(w * r)
    fh = hmax_i - hmin_i
    fw = wmax_i - wmin_i
    hrmax = torch.minimum(hmin_i + overlap_ratio * fh, rh - out_h)
    hrmin = torch.clamp(hmin_i + overlap_ratio * fh - out_h, min=0.0)
    wrmax = torch.minimum(wmin_i + overlap_ratio * fw, rw - out_w)
    wrmin = torch.clamp(wmin_i + overlap_ratio * fw - out_w, min=0.0)
    hrmax = torch.maximum(hrmax, hrmin + 1.0)
    wrmax = torch.maximum(wrmax, wrmin + 1.0)
    hbeg = torch.trunc(hrmin + draws['u_h'] * (hrmax - hrmin)).to(torch.int32)
    wbeg = torch.trunc(wrmin + draws['u_w'] * (wrmax - wrmin)).to(torch.int32)
    return r, hbeg, wbeg


def random_crop_resize_v2(images: torch.Tensor, masks: torch.Tensor,
                          keypoints: torch.Tensor, draws: dict, out_h: int,
                          out_w: int, **window_kw
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Scale and window jitter (augmentation.py:281-313): the geometry of
    :func:`crop_resize_v2_window` on the uniforms of
    :func:`draw_crop_resize_v2`, through :func:`crop_resize_instance_v2`
    (``trunc(h * r)`` and the begins move a whole pixel on one ulp, so a
    test holds the window first, then the resample on JAX's window)."""
    r, hbeg, wbeg = crop_resize_v2_window(masks, draws, out_h, out_w,
                                          **window_kw)
    return crop_resize_instance_v2(images, masks, keypoints, r,
                                   torch.ones_like(r, dtype=torch.bool),
                                   hbeg, wbeg, out_h, out_w)
