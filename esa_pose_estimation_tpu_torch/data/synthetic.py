"""Synthetic SPEED-like samples: the load generator of ``chip_smoke.py`` and
the pipeline tests (torch port of the JAX package's ``data/synthetic.py``).

* a fixed 30-point "spacecraft" model (:data:`SPACECRAFT_POINTS`);
* random poses from the SPEED distribution (depth 5..30 m, uniform
  rotation), drawn from an explicit ``torch.Generator``;
* full 1920x1200 frames rendered as per-keypoint-distinct Gaussian blobs
  whose local maxima sit at the projected keypoints.

Random draws cannot reproduce JAX's bits; tests that compare the two
packages make their frames with the JAX package and pass them as numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from esa_pose_estimation_tpu_torch.core import camera

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


def spacecraft_points(device=None) -> torch.Tensor:
    """The (30, 3) f32 keypoint model, metres."""
    return torch.tensor(SPACECRAFT_POINTS, dtype=torch.float32,
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


def scaled_intrinsics(height: int, width: int, device=None) -> torch.Tensor:
    """SPEED camera scaled to a non-native frame size."""
    K = torch.as_tensor(camera.SPEED_K, dtype=torch.float32, device=device)
    s = torch.tensor([width / 1920.0, height / 1200.0, 1.0],
                     dtype=torch.float32, device=device)
    return K * s[:, None]


def make_sample(generator: torch.Generator, points_3d: torch.Tensor,
                batch: int, height: int = 1200, width: int = 1920,
                render: bool = True) -> Sample:
    """``batch`` random poses with projected keypoints, a 12-pixel-margin
    box and (optionally) the rendered frame, on ``points_3d``'s device."""
    dev = points_3d.device
    q, t = random_pose(generator, batch, device=dev)
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
