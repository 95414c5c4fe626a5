"""Synthetic SPEED-like data: the load generator of ``chip_smoke.py``, the
pipeline tests and the synthetic training route (torch port of the JAX
package's ``data/synthetic.py``).

* a fixed 30-point "spacecraft" model (:data:`SPACECRAFT_POINTS`);
* random poses from the SPEED distribution (depth 5..30 m, uniform
  rotation), drawn from an explicit ``torch.Generator``;
* full 1920x1200 frames rendered as per-keypoint-distinct Gaussian blobs
  whose local maxima sit at the projected keypoints;
* :func:`make_batch`, a training batch rendered in crop space: crops,
  heatmap and weight targets (NHWC), optionally the full frames.

Random draws cannot reproduce JAX's bits.  So each random function is
split: :func:`random_pose` and :func:`draw_batch` draw, and
:func:`sample_from_pose` and :func:`make_batch` (given ``draws``) are
deterministic; tests inject the JAX package's draws there.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.data import augment
from esa_pose_estimation_tpu_torch.ops import crop as crop_ops
from esa_pose_estimation_tpu_torch.ops import heatmap as heatmap_ops

# The JAX package's ``spacecraft_points()`` (uniform in +-0.45 m from PRNG
# seed 1234, stretched by (1.3, 1.0, 0.6)), written out: torch cannot
# reproduce the JAX draw.  A test holds the two equal.
SPACECRAFT_POINTS = (
    (0.42705991864204407, 0.2753535211086273, -0.07159077376127243),
    (0.4069816470146179, -0.3226451575756073, 0.06969409435987473),
    (0.32272934913635254, -0.10631782561540604, -0.07808627188205719),
    (0.2587280869483948, 0.2804645299911499, -0.21618126332759857),
    (0.12496110796928406, 0.41569754481315613, -0.2114679366350174),
    (-0.548928439617157, -0.040554892271757126, 0.0264569241553545),
    (0.06516753882169724, 0.240899920463562, 0.25768184661865234),
    (0.014655041508376598, 0.1474248319864273, 0.0990719422698021),
    (0.019124792888760567, -0.3458732068538666, 0.15291379392147064),
    (0.48665928840637207, -0.07449062913656235, 0.05431731045246124),
    (0.26710495352745056, 0.3963030278682709, 0.09997934848070145),
    (0.43473267555236816, 0.3197782039642334, -0.008551633916795254),
    (0.5227642059326172, -0.3613334596157074, 0.25878801941871643),
    (0.16590242087841034, 0.07834528386592865, -0.2292175143957138),
    (-0.2547205686569214, -0.22598007321357727, -0.05932153761386871),
    (-0.28498202562332153, 0.06399256736040115, -0.23331885039806366),
    (0.4579722583293915, -0.3276820480823517, -0.2578689157962799),
    (-0.4369683265686035, 0.4090983271598816, 0.16378994286060333),
    (0.19474944472312927, 0.07285630702972412, 0.0855160802602768),
    (0.5153265595436096, -0.44095364212989807, 0.15301840007305145),
    (-0.4832625389099121, -0.28928107023239136, 0.022680159658193588),
    (-0.5802366137504578, 0.3133394122123718, 0.12242775410413742),
    (0.47678226232528687, -0.3875865936279297, -0.2585754692554474),
    (-0.1277807354927063, 0.2414574921131134, -0.18327751755714417),
    (0.08026987314224243, 0.43576186895370483, -0.21370728313922882),
    (-0.027424942702054977, -0.00321274995803833, -0.16377127170562744),
    (-0.4083229601383209, -0.42690059542655945, -0.2162756472826004),
    (-0.5679688453674316, -0.2483472228050232, 0.18671290576457977),
    (0.3188163638114929, -0.03032977506518364, 0.10677983611822128),
    (0.2831476330757141, -0.09793935716152191, 0.246019646525383),
)


def spacecraft_points(device=None, n: int = len(SPACECRAFT_POINTS)
                      ) -> torch.Tensor:
    """The (n, 3) f32 keypoint model, metres: the first ``n`` points, which
    is the JAX package's ``spacecraft_points(n)`` under the partitionable
    threefry its tests run (``hrnet_tiny`` has 6 keypoints)."""
    if not 0 < n <= len(SPACECRAFT_POINTS):
        raise ValueError(f'spacecraft_points: n={n} outside 1..'
                         f'{len(SPACECRAFT_POINTS)}')
    return torch.tensor(SPACECRAFT_POINTS[:n], dtype=torch.float32,
                        device=device)


class Sample(NamedTuple):
    image: torch.Tensor         # (B, H, W) full-frame float32 [0, 255]
    bbox: torch.Tensor          # (B, 4) [x1, y1, x2, y2]
    keypoints_2d: torch.Tensor  # (B, K, 2) full-frame pixels
    quat: torch.Tensor          # (B, 4) (w, x, y, z)
    trans: torch.Tensor         # (B, 3)


def random_pose(generator: torch.Generator, batch: int,
                min_depth: float = 5.0, max_depth: float = 30.0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch`` uniform random quaternions (w >= 0) + SPEED-plausible
    translations: depth uniform in [min_depth, max_depth], lateral offset
    uniform in +-0.16 x depth."""
    q = torch.randn((batch, 4), generator=generator, device=device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    depth = min_depth + (max_depth - min_depth) * torch.rand(
        (batch,), generator=generator, device=device)
    lateral = (torch.rand((batch, 2), generator=generator, device=device)
               * 0.32 - 0.16) * depth[:, None]
    return q, torch.cat([lateral, depth[:, None]], dim=-1)


def _spot_params(n_kp: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint blob (sigma, amplitude) in full-frame pixels: distinct
    appearance per keypoint, so keypoint identity is learnable."""
    k = torch.arange(n_kp, dtype=torch.float32, device=device)
    sigmas = 4.0 + 5.0 * (k % 5) / 4.0                     # 4..9 px
    amps = 0.45 + 0.55 * (((k * 7) % n_kp) / max(n_kp - 1, 1))
    return sigmas, amps


def render_frame(keypoints_2d: torch.Tensor, height: int = 1200,
                 width: int = 1920) -> torch.Tensor:
    """Render frames (..., H, W) from keypoints (..., K, 2) as a sum of
    per-keypoint-distinct Gaussian blobs, clipped to [0, 1] and scaled to
    [0, 255].  One keypoint at a time: a (K, H, W) stack would cost K
    frames of memory."""
    dev = keypoints_2d.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    sigmas, amps = _spot_params(keypoints_2d.shape[-2], dev)
    lead = keypoints_2d.shape[:-2]
    acc = torch.zeros(lead + (height, width), dtype=torch.float32,
                      device=dev)
    for k in range(keypoints_2d.shape[-2]):
        kx = keypoints_2d[..., k, 0][..., None, None]
        ky = keypoints_2d[..., k, 1][..., None, None]
        d2 = (xs - kx) ** 2 + (ys - ky) ** 2
        sig = sigmas[k]
        acc = acc + amps[k] * torch.exp(-d2 / (2.0 * sig * sig))
    return torch.clamp(acc, 0.0, 1.0) * 255.0


@lru_cache(maxsize=8)
def scaled_intrinsics(height: int, width: int, device=None) -> torch.Tensor:
    """SPEED camera scaled to a non-native frame size, made once per (size,
    device): every training batch needs it, and a copy from host memory
    would make the host wait for the queued kernels.  Shared: do not write
    to it."""
    K = camera.speed_k(torch.float32, device)
    s = torch.tensor([width / 1920.0, height / 1200.0, 1.0],
                     dtype=torch.float32, device=device)
    return K * s[:, None]


def sample_from_pose(q: torch.Tensor, t: torch.Tensor,
                     points_3d: torch.Tensor, height: int = 1200,
                     width: int = 1920, render: bool = True) -> Sample:
    """Poses (B, 4) and (B, 3) -> projected keypoints, a 12-pixel-margin
    box and (optionally) the rendered frame."""
    batch = q.shape[0]
    dev = points_3d.device
    K = scaled_intrinsics(height, width, dev)
    R = camera.quat_to_rotmat(q)
    uv = camera.project_points(points_3d.expand((batch,) + points_3d.shape),
                               R, t, K)
    margin = 12.0
    x1 = torch.clamp(uv[..., 0].amin(-1) - margin, 0, width - 1)
    y1 = torch.clamp(uv[..., 1].amin(-1) - margin, 0, height - 1)
    x2 = torch.clamp(uv[..., 0].amax(-1) + margin, 0, width - 1)
    y2 = torch.clamp(uv[..., 1].amax(-1) + margin, 0, height - 1)
    bbox = torch.stack([x1, y1, x2, y2], dim=-1)
    image = (render_frame(uv, height, width) if render
             else torch.zeros((batch, height, width), dtype=torch.float32,
                              device=dev))
    return Sample(image=image, bbox=bbox, keypoints_2d=uv, quat=q, trans=t)


def make_sample(generator: torch.Generator, points_3d: torch.Tensor,
                batch: int, height: int = 1200, width: int = 1920,
                render: bool = True) -> Sample:
    """``batch`` random poses with projected keypoints, a 12-pixel-margin
    box and (optionally) the rendered frame, on ``points_3d``'s device."""
    q, t = random_pose(generator, batch, device=points_3d.device)
    return sample_from_pose(q, t, points_3d, height, width, render)


def draw_batch(generator: torch.Generator, batch_size: int,
               crop_size: int = 128, augment_geom: bool = False,
               augment_photo: bool = False, device=None) -> dict:
    """:func:`make_batch`'s random draws: poses (``quat``, ``trans``);
    with ``augment_geom`` a flip coin and an in-plane angle in [-pi, pi)
    per sample (``flip``, ``theta``); with ``augment_photo`` the
    ``augment.draw_perturb`` dict of the crops (``photo``)."""
    q, t = random_pose(generator, batch_size, device=device)
    draws = {'quat': q, 'trans': t}
    if augment_geom:
        draws['flip'] = torch.rand((batch_size,), generator=generator,
                                   device=device) < 0.5
        draws['theta'] = (torch.rand((batch_size,), generator=generator,
                                     device=device) * 2.0 - 1.0) * math.pi
    if augment_photo:
        draws['photo'] = augment.draw_perturb(generator, batch_size,
                                              crop_size, crop_size,
                                              device=device)
    return draws


def make_batch(generator: torch.Generator | None, batch_size: int,
               points_3d: torch.Tensor, crop_size: int = 128,
               sigma: float = 2.0, render: bool = True,
               with_frames: bool = False, height: int = 1200,
               width: int = 1920, augment_geom: bool = False,
               augment_photo: bool = False,
               draws: dict | None = None) -> dict[str, torch.Tensor]:
    """A training batch on ``points_3d``'s device: crops + heatmap/weight
    targets (NHWC), as ESADataSet.__getitem__ (data_load4.py:103-203) makes
    them: box x1.05 square -> keypoints to crop space -> Gaussian targets +
    weight maps -> normalize.

    The crop imagery is rendered in crop space (Gaussian blobs at the
    crop-space keypoints with the crop-scaled spot size) instead of
    rendering 1920x1200 frames and resampling them: the same geometry at
    about 1% of the pixel work.  ``augment_geom`` flips and rotates the
    crop-space keypoints before anything is rendered from them (the pose
    labels are not transformed: such batches train heatmaps only);
    ``augment_photo`` perturbs the crop imagery (``augment.perturb_capture``).
    ``with_frames`` also renders the full frames (``frame`` (B, H, W) and
    full-frame ``keypoints_2d``) so that an evaluation can drive the whole
    serving path on the samples that made the targets.

    ``draws`` (from :func:`draw_batch`) replaces the generator's draws.
    """
    if draws is None:
        draws = draw_batch(generator, batch_size, crop_size, augment_geom,
                           augment_photo, device=points_3d.device)
    s = sample_from_pose(draws['quat'], draws['trans'], points_3d, height,
                         width, render=False)
    return batch_from_sample(s, draws, crop_size, sigma, render, with_frames,
                             height, width, augment_geom, augment_photo)


def batch_from_sample(s: Sample, draws: dict, crop_size: int = 128,
                      sigma: float = 2.0, render: bool = True,
                      with_frames: bool = False, height: int = 1200,
                      width: int = 1920, augment_geom: bool = False,
                      augment_photo: bool = False
                      ) -> dict[str, torch.Tensor]:
    """:func:`make_batch` from its samples (poses, full-frame keypoints,
    boxes; ``s.image`` is not read) and its augmentation draws."""
    dev = s.keypoints_2d.device
    batch_size, n_kp = s.keypoints_2d.shape[:2]
    origins, _, size = crop_ops.adjust_bbox(s.bbox, img_w=width,
                                            img_h=height)
    rates = crop_size / size.to(torch.float32)
    kp_crop = (s.keypoints_2d - origins[:, None, :].to(torch.float32)
               ) * rates[:, None, None]
    if augment_geom:
        c = (crop_size - 1) / 2.0
        flip = draws['flip'][:, None]
        x = torch.where(flip, 2.0 * c - kp_crop[..., 0], kp_crop[..., 0]) - c
        y = kp_crop[..., 1] - c
        ct = torch.cos(draws['theta'])[:, None]
        st = torch.sin(draws['theta'])[:, None]
        kp_crop = torch.stack([c + ct * x - st * y, c + st * x + ct * y],
                              dim=-1)
    hm, wm = heatmap_ops.render_targets(kp_crop, crop_size, crop_size, sigma)
    if render:
        # per-(sample, keypoint) spot sigma s = sigma_k * rate, as
        # exp((-d2 / 2) * (1 / s^2)): the JAX package writes
        # exp(-d2/2) ** (1/s^2), which XLA rewrites to this form, and which
        # would underflow to 0 away from the spot if evaluated as written
        sigmas, amps = _spot_params(n_kp, dev)
        s2 = (sigmas[None, :] * rates[:, None]) ** 2
        d2 = heatmap_ops.squared_distances(kp_crop, crop_size, crop_size)
        spot = torch.exp((-d2 / 2.0) * (1.0 / s2[:, :, None, None]))
        crops = torch.clamp((amps[None, :, None, None] * spot).sum(1),
                            0.0, 1.0) * 255.0
    else:
        crops = torch.zeros((batch_size, crop_size, crop_size),
                            dtype=torch.float32, device=dev)
    if augment_photo:
        crops = augment.perturb_capture(crops, draws['photo'])
    batch = {
        'image': crop_ops.normalize(crops)[..., None],      # (B, S, S, 1)
        'heatmaps': hm.permute(0, 2, 3, 1),                 # NHWC
        'weights': wm.permute(0, 2, 3, 1),
        'keypoints_crop': kp_crop,
        'rate': rates,
        'origin': origins,
        'quat': s.quat,
        'trans': s.trans,
        'bbox': s.bbox,
    }
    if with_frames:
        batch['frame'] = render_frame(s.keypoints_2d, height, width)
        batch['keypoints_2d'] = s.keypoints_2d
    return batch
