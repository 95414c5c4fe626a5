"""The benchmark's one traffic generator: SPEED-like frames and training
batches made on the card from the seed, read by every cell through the
parameters of its workload file.

What it makes is what the r5 weights were trained on (the port's
``data/synthetic.py``): a fixed 30-point spacecraft model in uniform random
rotations at 5 to 30 m, its keypoints projected by the SPEED camera and
rendered into a 1920x1200 frame as per-keypoint-distinct Gaussian blobs
(sigma 4 to 9 px, amplitudes 0.45 to 1), a box 12 px outside the
keypoints.  The generator is the harness's own and imports nothing of the
port:

* :func:`frame_pool` renders ``n`` frames as uint8 with one batched
  product per chunk: a sum over keypoints of separable Gaussians is
  ``GY @ GX`` with ``GY[h, k] = a_k exp(-dy^2 / 2 s_k^2)`` and
  ``GX[k, w] = exp(-dx^2 / 2 s_k^2)``;
* :func:`train_pool` makes model-ready batches: a normalised 128x128 crop
  of the same blobs rendered in crop space, 30 Gaussian targets (sigma 2)
  and their 3x3-dilated weight maps, as the reference's data loader
  (``data_load4.py:103-203``) makes them.

Every draw comes from a ``torch.Generator`` on the card seeded from the
seed and a stream name (:func:`generator`), so a seed gives the same
inputs on every run; the seed changes the poses, not the sizes.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from h100_bench.reference import camera, crop, heatmap

# the port's SPACECRAFT_POINTS (uniform in +-0.45 m, stretched by (1.3,
# 1.0, 0.6)), the keypoint model the r5 weights were trained on
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


def points_3d(n: int, device) -> torch.Tensor:
    """The (n, 3) f32 keypoint model, metres."""
    return torch.tensor(SPACECRAFT_POINTS[:n], dtype=torch.float32,
                        device=device)


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for one named stream of draws of one run: any
    ``seed`` (a large one too) and the names, hashed."""
    text = ':'.join([str(int(seed))] + [str(n) for n in names])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          'little') >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *names))


def spot_params(n_kp: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint blob (sigma px, amplitude): distinct per keypoint."""
    k = torch.arange(n_kp, dtype=torch.float32, device=device)
    sigmas = 4.0 + 5.0 * (k % 5) / 4.0
    amps = 0.45 + 0.55 * (((k * 7) % n_kp) / max(n_kp - 1, 1))
    return sigmas, amps


def random_pose(gen: torch.Generator, batch: int, min_depth: float,
                max_depth: float, device, stratified: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform rotations (w >= 0) and translations at a uniform depth with
    a lateral offset within +-0.16 of the depth.  ``stratified``: the
    depths are the ``batch`` midpoints of equal steps over the range, in
    an order drawn from ``gen``, so every seed has the same set of depths
    (and of box sizes, as far as the depth sets them)."""
    q = torch.randn((batch, 4), generator=gen, device=device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    if stratified:
        step = torch.randperm(batch, generator=gen, device=device) + 0.5
        depth = min_depth + (max_depth - min_depth) * step / batch
    else:
        depth = min_depth + (max_depth - min_depth) * torch.rand(
            (batch,), generator=gen, device=device)
    lateral = (torch.rand((batch, 2), generator=gen, device=device)
               * 0.32 - 0.16) * depth[:, None]
    return q, torch.cat([lateral, depth[:, None]], dim=-1)


def project(q: torch.Tensor, t: torch.Tensor, pts: torch.Tensor
            ) -> torch.Tensor:
    """(B, K, 2) full-frame pixels of the keypoint model under the poses."""
    K = camera.speed_k(torch.float32, pts.device)
    R = camera.quat_to_rotmat(q)
    return camera.project_points(pts.expand((q.shape[0],) + pts.shape),
                                 R, t, K)


def boxes_of(uv: torch.Tensor, margin: float, height: int, width: int
             ) -> torch.Tensor:
    """The keypoints' box grown by ``margin`` px and clipped to the frame."""
    x1 = torch.clamp(uv[..., 0].amin(-1) - margin, 0, width - 1)
    y1 = torch.clamp(uv[..., 1].amin(-1) - margin, 0, height - 1)
    x2 = torch.clamp(uv[..., 0].amax(-1) + margin, 0, width - 1)
    y2 = torch.clamp(uv[..., 1].amax(-1) + margin, 0, height - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def render_frames(uv: torch.Tensor, height: int, width: int,
                  chunk: int = 64) -> torch.Tensor:
    """uint8 frames (B, H, W) of the blobs at ``uv`` (B, K, 2), a batched
    f32 product per ``chunk`` frames."""
    dev = uv.device
    sig, amp = spot_params(uv.shape[1], dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    out = torch.empty((uv.shape[0], height, width), dtype=torch.uint8,
                      device=dev)
    inv = 1.0 / (2.0 * sig * sig)
    for s in range(0, uv.shape[0], chunk):
        u = uv[s:s + chunk]
        gx = torch.exp(-(xs[None, None, :] - u[..., 0:1]) ** 2
                       * inv[None, :, None])                  # (b, K, W)
        gy = torch.exp(-(ys[None, None, :] - u[..., 1:2]) ** 2
                       * inv[None, :, None]) * amp[None, :, None]
        img = torch.bmm(gy.transpose(1, 2), gx)               # (b, H, W)
        out[s:s + chunk] = torch.round(
            torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return out


class FramePool(NamedTuple):
    frames: torch.Tensor      # (N, H, W) uint8
    boxes: torch.Tensor       # (N, 4) f32 [x1, y1, x2, y2]
    keypoints: torch.Tensor   # (N, K, 2) f32, the true projections
    quat: torch.Tensor        # (N, 4)
    trans: torch.Tensor       # (N, 3)


def frame_pool(seed: int, traffic: dict, n_kp: int, device) -> FramePool:
    """``traffic['pool_frames']`` distinct frames of the seed."""
    h, w = traffic['height'], traffic['width']
    q, t = random_pose(generator(device, seed, 'poses'),
                       traffic['pool_frames'], traffic['min_depth_m'],
                       traffic['max_depth_m'], device,
                       traffic.get('stratified_depths', False))
    uv = project(q, t, points_3d(n_kp, device))
    return FramePool(render_frames(uv, h, w),
                     boxes_of(uv, traffic['box_margin_px'], h, w), uv, q, t)


def batch_from_keypoints(uv: torch.Tensor, height: int, width: int,
                         crop_size: int, sigma: float, margin: float
                         ) -> dict[str, torch.Tensor]:
    """A model-ready batch from full-frame keypoints (B, K, 2): the
    ``data_load4`` crop box (x1.05, square), the keypoints in crop space,
    the blobs rendered there at the crop's scale, normalised, and the
    Gaussian targets with their weight maps, channels last."""
    dev = uv.device
    box = boxes_of(uv, margin, height, width)
    origins, _, size = crop.adjust_bbox(box, img_w=width, img_h=height)
    rates = crop_size / size.to(torch.float32)
    kp = (uv - origins[:, None, :].to(torch.float32)) * rates[:, None, None]
    hm, wm = heatmap.render_targets(kp, crop_size, crop_size, sigma)
    sig, amp = spot_params(uv.shape[1], dev)
    s2 = (sig[None, :] * rates[:, None]) ** 2
    d2 = heatmap.squared_distances(kp, crop_size, crop_size)
    spot = torch.exp((-d2 / 2.0) * (1.0 / s2[:, :, None, None]))
    crops = torch.clamp((amp[None, :, None, None] * spot).sum(1),
                        0.0, 1.0) * 255.0
    return {'image': crop.normalize(crops)[..., None],
            'heatmaps': hm.permute(0, 2, 3, 1).contiguous(),
            'weights': wm.permute(0, 2, 3, 1).contiguous()}


def train_pool(seed: int, rank: int, traffic: dict, n_kp: int, crop_size: int,
               sigma: float, device) -> list[dict[str, torch.Tensor]]:
    """``traffic['pool_batches']`` distinct batches of ``traffic['batch']``
    rows for ``rank``, each row a pose of its own."""
    n, b = traffic['pool_batches'], traffic['batch']
    q, t = random_pose(generator(device, seed, 'train', rank), n * b,
                       traffic['min_depth_m'], traffic['max_depth_m'], device)
    uv = project(q, t, points_3d(n_kp, device))
    return [batch_from_keypoints(uv[i * b:(i + 1) * b], traffic['height'],
                                 traffic['width'], crop_size, sigma,
                                 traffic['box_margin_px'])
            for i in range(n)]
