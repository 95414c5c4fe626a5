"""Viewpoint sampling and mesh rasterization (torch port of the JAX
package's ``utils/render.py``).

* viewpoint / pose sampling — reference lib/utils/render_utils.py:16-121,
  host numpy, the JAX module's functions unchanged;
* binary mask and depth rasterization — reference
  lib/utils/extend_utils/src/mesh_rasterization.cpp:1-74 (CPU triangle
  fill) and the z-buffer role of opengl_render_backend.py:165-392, as a
  batched edge-function test over pixels, looped over triangle chunks;
* shaded colour (:func:`rasterize_color`, :func:`render_color`), the
  reference OpenGL colour renderer's role.

:func:`rasterize` and :func:`rasterize_color` render a whole batch of
poses of one mesh in one call (the JAX versions render one image): each
chunk is one set of (B, chunk, H*W) element-wise tensors.  As in JAX, depth is interpolated
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


def _pixel_grid(height: int, width: int, device):
    """x and y of every pixel, (1, 1, H*W) each."""
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :] \
        .expand(height, width).reshape(1, 1, -1)
    py = torch.arange(height, dtype=torch.float32, device=device)[:, None] \
        .expand(height, width).reshape(1, 1, -1)
    return px, py


def _chunk_geometry(uv, z, tri, px, py):
    """One chunk of triangles against every pixel, for the batch of
    poses: barycentric weights (b0, b1, b2), the interpolated inverse
    depth ``inv_z`` and the depth (+inf outside) of each triangle at each
    pixel, all (B, C, H*W), and ``inside`` (B, C, H*W) bool."""
    ua, ub, uc = uv[:, tri[:, 0]], uv[:, tri[:, 1]], uv[:, tri[:, 2]]
    za, zb, zc = z[:, tri[:, 0]], z[:, tri[:, 1]], z[:, tri[:, 2]]
    ax, ay = ua[..., 0, None], ua[..., 1, None]               # (B, C, 1)
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
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    # perspective-correct depth: 1/z is affine in screen space
    inv_z = (b0 / torch.clamp(za, min=_Z_NEAR)[..., None]
             + b1 / torch.clamp(zb, min=_Z_NEAR)[..., None]
             + b2 / torch.clamp(zc, min=_Z_NEAR)[..., None])
    zint = 1.0 / torch.clamp(inv_z, min=1e-12)
    tri_depth = torch.where(inside, zint, torch.inf)
    return (b0, b1, b2), inv_z, tri_depth, inside


def _flat_poses(vertices, R, t, K):
    """Poses flattened to (B, ...): the leading shape, R, t, the projected
    vertices (B, V, 2) and their camera-frame points (B, V, 3)."""
    lead = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    t = t.reshape(-1, 3)
    uv = project_points(vertices, R, t, K)
    cam = torch.einsum('bij,nj->bni', R, vertices) + t[:, None]
    return lead, uv, cam


def rasterize(vertices: torch.Tensor, faces: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor, K: torch.Tensor, height: int, width: int,
              chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize a triangle mesh under a batch of poses.

    vertices (V, 3); faces (F, 3) integer; R (..., 3, 3); t (..., 3); K
    (3, 3).  Returns (mask (..., H, W) bool, depth (..., H, W) f32, +inf
    where empty), on the vertices' device.
    """
    lead, uv, cam = _flat_poses(vertices, R, t, K)
    b = uv.shape[0]
    dev = vertices.device
    chunk = _bounded_chunk(chunk, b, height, width)
    z = cam[..., 2]
    px, py = _pixel_grid(height, width, dev)
    faces = faces.to(device=dev, dtype=torch.int64)
    mask = torch.zeros((b, height * width), dtype=torch.bool, device=dev)
    depth = torch.full((b, height * width), torch.inf, device=dev)
    for c0 in range(0, faces.shape[0], chunk):
        _, _, tri_depth, inside = _chunk_geometry(
            uv, z, faces[c0:c0 + chunk], px, py)
        depth = torch.minimum(depth, tri_depth.amin(dim=1))
        mask = mask | inside.any(dim=1)
    return (mask.reshape(lead + (height, width)),
            depth.reshape(lead + (height, width)))


def rasterize_color(vertices: torch.Tensor, faces: torch.Tensor,
                    R: torch.Tensor, t: torch.Tensor, K: torch.Tensor,
                    height: int, width: int,
                    vertex_colors: torch.Tensor | None = None,
                    light_dir: tuple[float, float, float] = (0.0, 0.0, 1.0),
                    ambient: float = 0.35, chunk: int = 128
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Colour and depth of a triangle mesh under a batch of poses: the
    role of the reference's OpenGL colour renderer for synthetic LINEMOD
    appearance (opengl_render_backend.py:165-392, render_utils.py:161-274).

    vertices (V, 3); faces (F, 3); R (..., 3, 3); t (..., 3); vertex_colors
    (V, 3) in [0, 1] (light grey by default).  Perspective-correct
    barycentric colour, shaded one-sided Lambert from the camera-frame
    face normal: ``shade = ambient + (1 - ambient) * max(0, -n . l)``, the
    normal turned toward the camera first (a visible face faces the
    camera; PLY winding is not reliable), so back-lit faces get the
    ambient only.  ``light_dir`` is the direction light travels in the
    camera frame; (0, 0, 1) is a headlight.  Each pixel takes the first
    triangle, in face order, at its least depth.

    Returns (rgb (..., H, W, 3) f32 in [0, 1], black where empty; depth
    (..., H, W) f32, +inf where empty; mask (..., H, W) bool).
    """
    lead, uv, cam = _flat_poses(vertices, R, t, K)
    b = uv.shape[0]
    dev = vertices.device
    chunk = _bounded_chunk(chunk, b, height, width)
    if vertex_colors is None:
        vertex_colors = torch.full(vertices.shape, 0.8, device=dev)
    z = cam[..., 2]
    px, py = _pixel_grid(height, width, dev)
    faces = faces.to(device=dev, dtype=torch.int64)
    light = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
    light = light / torch.linalg.vector_norm(light)
    p = height * width
    depth = torch.full((b, p), torch.inf, device=dev)
    color = torch.zeros((b, p, 3), device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    for c0 in range(0, faces.shape[0], chunk):
        tri = faces[c0:c0 + chunk]
        (b0, b1, b2), inv_z, tri_depth, _ = _chunk_geometry(uv, z, tri, px,
                                                            py)
        win = tri_depth.argmin(dim=1, keepdim=True)           # (B, 1, P)

        def at(a):
            return a.gather(1, win)[:, 0]                     # (B, P)
        win_depth = at(tri_depth)
        # perspective-correct attribute weights: (b_i / z_i) / sum_j
        safe_iz = torch.clamp(at(inv_z), min=1e-12)
        zs = torch.clamp(z[:, tri], min=_Z_NEAR)              # (B, C, 3)
        wt = win[:, 0]
        bw = torch.stack([at(b0) / zs[..., 0].gather(1, wt),
                          at(b1) / zs[..., 1].gather(1, wt),
                          at(b2) / zs[..., 2].gather(1, wt)],
                         dim=-1) / safe_iz[..., None]         # (B, P, 3)
        vcol = vertex_colors[tri[wt]]                         # (B, P, 3, 3)
        col = torch.einsum('bpv,bpvc->bpc', bw, vcol)
        # one-sided Lambert from the camera-frame face normal, turned
        # toward the camera
        ca, cb, cc = cam[:, tri[:, 0]], cam[:, tri[:, 1]], cam[:, tri[:, 2]]
        n = torch.linalg.cross(cb - ca, cc - ca)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
        centroid = (ca + cb + cc) / 3.0
        n = torch.where(((n * centroid).sum(-1) > 0)[..., None], -n, n)
        ndotl = torch.clamp(-(n @ light), min=0.0)            # (B, C)
        col = col * (ambient + (1.0 - ambient)
                     * ndotl[bidx, wt])[..., None]
        better = win_depth < depth
        depth = torch.where(better, win_depth, depth)
        color = torch.where(better[..., None], col, color)
    return (color.reshape(lead + (height, width, 3)),
            depth.reshape(lead + (height, width)),
            torch.isfinite(depth).reshape(lead + (height, width)))


def render_color(vertices, faces, pose, K, height: int, width: int,
                 vertex_colors=None) -> np.ndarray:
    """uint8 (..., H, W, 3) appearance of [R|t] poses (..., 3, 4)
    (opengl_render_backend.py ``render()``), on the device of ``vertices``
    when it is a tensor, else on the CPU."""
    verts = torch.as_tensor(vertices, dtype=torch.float32)
    dev = verts.device
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    vc = (None if vertex_colors is None else
          torch.as_tensor(vertex_colors, dtype=torch.float32, device=dev))
    rgb, _, _ = rasterize_color(
        verts, torch.as_tensor(faces, device=dev), pose[..., :3],
        pose[..., 3], torch.as_tensor(K, dtype=torch.float32, device=dev),
        height, width, vc)
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


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
