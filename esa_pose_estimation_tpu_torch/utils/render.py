"""Viewpoint sampling and mesh rasterization (torch port of the mask and
depth part of the JAX package's ``utils/render.py``).

* viewpoint / pose sampling — reference lib/utils/render_utils.py:16-121,
  host numpy, the JAX module's functions unchanged;
* binary mask and depth rasterization — reference
  lib/utils/extend_utils/src/mesh_rasterization.cpp:1-74 (CPU triangle
  fill) and the z-buffer role of opengl_render_backend.py:165-392, as a
  batched edge-function test over pixels, looped over triangle chunks.

:func:`rasterize` renders a whole batch of poses of one mesh in one call
(the JAX version ``vmap``s one image at a time): each chunk is one set of
(B, chunk, H*W) element-wise tensors.  As in JAX, depth is interpolated
perspective-correctly (1/z is affine in screen space), triangles with a
vertex at or behind the near plane are dropped, and the chunk shrinks with
the pixel count so each intermediate stays near 64 MB.
"""

from __future__ import annotations

import numpy as np
import torch

from esa_pose_estimation_tpu_torch.core.camera import project_points

_Z_NEAR = 1e-6


def sample_sphere_points(n: int, seed: int = 0) -> np.ndarray:
    """n approximately-uniform unit-sphere points: a Fibonacci spiral
    turned by a seed-derived random rotation."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    golden = np.pi * (1 + 5 ** 0.5)
    theta = golden * i
    pts = np.stack([np.cos(theta) * np.sin(phi),
                    np.sin(theta) * np.sin(phi),
                    np.cos(phi)], axis=-1)
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return pts @ Q.T


def sample_poses(n: int, min_dist: float, max_dist: float,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random viewpoints: (rotations (n, 3, 3) looking at the origin from
    the sphere points, translations (n, 3) along the optical axis)."""
    rng = np.random.default_rng(seed)
    views = sample_sphere_points(n, seed)
    rng.shuffle(views)
    ups = rng.normal(size=(n, 3))
    Rs = np.zeros((n, 3, 3))
    for i in range(n):
        z = -views[i]
        z = z / np.linalg.norm(z)
        x = np.cross(ups[i], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        Rs[i] = np.stack([x, y, z])
    dists = rng.uniform(min_dist, max_dist, size=n)
    ts = np.stack([np.zeros(n), np.zeros(n), dists], axis=-1)
    return Rs, ts


def pose_statistics(Rs: np.ndarray, ts: np.ndarray) -> dict[str, np.ndarray]:
    """Azimuth, elevation (degrees) and distance of a pose set."""
    z_axis = Rs[:, 2, :]
    elevation = np.degrees(np.arcsin(np.clip(z_axis[:, 2], -1, 1)))
    azimuth = np.degrees(np.arctan2(z_axis[:, 1], z_axis[:, 0]))
    dist = np.linalg.norm(ts, axis=-1)
    return {'azimuth': azimuth, 'elevation': elevation, 'distance': dist}


def _bounded_chunk(chunk: int, batch: int, height: int, width: int) -> int:
    """Shrink the triangle chunk so each (batch, chunk, H*W) f32
    intermediate is at most about 64 MB."""
    per_row = batch * height * width * 4
    return max(1, min(chunk, (64 << 20) // max(per_row, 1)))


def _edge(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def rasterize(vertices: torch.Tensor, faces: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor, K: torch.Tensor, height: int, width: int,
              chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize a triangle mesh under a batch of poses.

    vertices (V, 3); faces (F, 3) integer; R (..., 3, 3); t (..., 3); K
    (3, 3).  Returns (mask (..., H, W) bool, depth (..., H, W) f32, +inf
    where empty), on the vertices' device.
    """
    lead = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    t = t.reshape(-1, 3)
    b = R.shape[0]
    dev = vertices.device
    chunk = _bounded_chunk(chunk, b, height, width)
    uv = project_points(vertices, R, t, K)                    # (B, V, 2)
    z = (torch.einsum('bij,nj->bni', R, vertices) + t[:, None])[..., 2]
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] \
        .expand(height, width).reshape(1, 1, -1)
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] \
        .expand(height, width).reshape(1, 1, -1)
    faces = faces.to(device=dev, dtype=torch.int64)
    mask = torch.zeros((b, height * width), dtype=torch.bool, device=dev)
    depth = torch.full((b, height * width), torch.inf, device=dev)
    for c0 in range(0, faces.shape[0], chunk):
        tri = faces[c0:c0 + chunk]
        ua, ub, uc = uv[:, tri[:, 0]], uv[:, tri[:, 1]], uv[:, tri[:, 2]]
        za, zb, zc = z[:, tri[:, 0]], z[:, tri[:, 1]], z[:, tri[:, 2]]
        ax, ay = ua[..., 0, None], ua[..., 1, None]           # (B, C, 1)
        bx, by = ub[..., 0, None], ub[..., 1, None]
        cx, cy = uc[..., 0, None], uc[..., 1, None]
        area = _edge(ax, ay, bx, by, cx, cy)
        sa = torch.where(area == 0, 1.0, torch.sign(area))
        w0 = _edge(bx, by, cx, cy, px, py) * sa
        w1 = _edge(cx, cy, ax, ay, px, py) * sa
        w2 = _edge(ax, ay, bx, by, px, py) * sa
        # near-plane guard: a vertex at z <= 0 projects mirrored (or NaN)
        front = ((za > _Z_NEAR) & (zb > _Z_NEAR) & (zc > _Z_NEAR))[..., None]
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area != 0) & front)
        denom = torch.clamp(area.abs(), min=1e-12)
        # perspective-correct depth: 1/z is affine in screen space
        inv_z = (w0 / denom / torch.clamp(za, min=_Z_NEAR)[..., None]
                 + w1 / denom / torch.clamp(zb, min=_Z_NEAR)[..., None]
                 + w2 / denom / torch.clamp(zc, min=_Z_NEAR)[..., None])
        zint = 1.0 / torch.clamp(inv_z, min=1e-12)
        tri_depth = torch.where(inside, zint, torch.inf)
        depth = torch.minimum(depth, tri_depth.amin(dim=1))
        mask = mask | inside.any(dim=1)
    return (mask.reshape(lead + (height, width)),
            depth.reshape(lead + (height, width)))


def rasterize_mask(vertices, faces, pose, K, height: int, width: int
                   ) -> np.ndarray:
    """Binary mask of one (3, 4) [R|t] pose as numpy (mesh_rasterization
    .cpp:1-74 parity), on the CPU."""
    pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32)
    mask, _ = rasterize(torch.as_tensor(np.asarray(vertices),
                                        dtype=torch.float32),
                        torch.as_tensor(np.asarray(faces)),
                        pose[:, :3], pose[:, 3],
                        torch.as_tensor(np.asarray(K), dtype=torch.float32),
                        height, width)
    return mask.numpy()
