"""Train-time augmentation on the device (torch port of the part of the JAX
package's ``data/augment.py`` that keypoint training imports).

* :func:`color_jitter` — ``ColorJitter(0.1, 0.1, 0.05, 0.05)`` on grayscale
  crops (data_load4.py:78-83): brightness and contrast in a random order
  per sample (saturation and hue are identities on one channel);
* :func:`affine_sample` / :func:`rotation_matrices` — batched inverse-warp
  sampling, used by the crop-space rotation of ``data/pipeline.py``;
* :func:`perturb_capture` — exposure gain/offset, then the reference
  augmentation library's gaussian-noise-or-motion-blur coin
  (augmentation.py:207-233), the ``--augment-photo`` transform and the
  ``cli/eval_synthetic --perturb`` probe.

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
                  fill: float = 0.0) -> torch.Tensor:
    """Bilinear inverse warp of (B, H, W) or (B, H, W, C) images by
    per-sample (B, 2, 3) affines mapping OUTPUT pixel (x, y, 1) to input
    coordinates; out-of-bounds samples take ``fill``."""
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
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = images.reshape(b, h * w, c)

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
