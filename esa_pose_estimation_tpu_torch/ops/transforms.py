"""Test-time transform helpers (torch port of the JAX package's
``ops/transforms.py``; reference transforms.py:16-122).

The HRNet family's affine and flip helpers for flip test-time
augmentation and letterbox crops: ``flip_back`` (un-flip heatmaps and
swap left/right channels), ``fliplr_joints``, ``get_affine_transform``
(the centre/scale/rotation 3-point affine, scale in the x200 person-box
convention), ``transform_preds`` and ``crop``.  Batched: channel swaps
are index permutations, the 3-point affine is a solve per sample, and
``crop`` warps through :func:`affine_sample_sized` in place of a
cv2.warpAffine per image.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _pair_permutation(num_joints: int,
                      matched_parts: Sequence[Sequence[int]],
                      device=None) -> torch.Tensor:
    """The channel permutation that swaps each (left, right) pair."""
    perm = list(range(num_joints))
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    return torch.tensor(perm, dtype=torch.int64, device=device)


def flip_back(output_flipped: torch.Tensor,
              matched_parts: Sequence[Sequence[int]] = ()) -> torch.Tensor:
    """Un-flip heatmaps predicted on a horizontally flipped input
    (transforms.py:16-30): reverse the width axis and swap the left/right
    channels.  output_flipped: (B, K, H, W).  SPEED's keypoints have no
    mirror pairs, so ``matched_parts`` is empty there."""
    out = torch.flip(output_flipped, dims=(3,))
    if matched_parts:
        out = out[:, _pair_permutation(out.shape[1], matched_parts,
                                       out.device)]
    return out


def fliplr_joints(joints: torch.Tensor, joints_vis: torch.Tensor, width: int,
                  matched_parts: Sequence[Sequence[int]] = ()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flip 2D joints horizontally (transforms.py:33-47).  joints
    (..., K, 2); joints_vis (..., K, V).  Returns (joints times the first
    visibility column, joints_vis), as the reference."""
    joints = torch.stack([width - joints[..., 0] - 1, joints[..., 1]],
                         dim=-1)
    if matched_parts:
        perm = _pair_permutation(joints.shape[-2], matched_parts,
                                 joints.device)
        joints = joints[..., perm, :]
        joints_vis = joints_vis[..., perm, :]
    return joints * joints_vis[..., :1], joints_vis


def _get_dir(src_point: torch.Tensor, rot_rad: float) -> torch.Tensor:
    sn, cs = math.sin(rot_rad), math.cos(rot_rad)
    return torch.stack([src_point[..., 0] * cs - src_point[..., 1] * sn,
                        src_point[..., 0] * sn + src_point[..., 1] * cs],
                       dim=-1)


def _get_3rd_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    direct = a - b
    return b + torch.stack([-direct[..., 1], direct[..., 0]], dim=-1)


def _solve_affine(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) affine taking three src points to three dst points
    (cv2.getAffineTransform).  src, dst: (..., 3, 2)."""
    A = torch.cat([src, torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                                   device=src.device)], dim=-1)
    return torch.linalg.solve(A, dst).transpose(-1, -2)


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv: bool = False
                         ) -> torch.Tensor:
    """The centre/scale/rotation 3-point affine (transforms.py:58-90):
    scale in the x200-pixel person-box convention; the points are the box
    centre, a point half a box up (rotated), and their 90-degree third.
    center (..., 2); scale (..., 2) or (...) for square.  Returns
    (..., 2, 3)."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    if scale.shape[-1:] != (2,) or scale.dim() < center.dim():
        scale = torch.stack([scale, scale], dim=-1)
    scale, center = torch.broadcast_tensors(scale, center)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=center.device)
    scale_tmp = scale * 200.0
    src_w = scale_tmp[..., 0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    rot_rad = float(rot) * math.pi / 180.0
    src_dir = _get_dir(torch.stack([torch.zeros_like(src_w),
                                    (src_w - 1) * -0.5], dim=-1), rot_rad)
    dst_dir = torch.tensor([0.0, (dst_w - 1) * -0.5], device=center.device)
    src0 = center + scale_tmp * shift
    src1 = center + src_dir + scale_tmp * shift
    dst0 = torch.tensor([(dst_w - 1) * 0.5, (dst_h - 1) * 0.5],
                        device=center.device).expand_as(src0)
    dst1 = dst0 + dst_dir
    src = torch.stack([src0, src1, _get_3rd_point(src0, src1)], dim=-2)
    dst = torch.stack([dst0, dst1, _get_3rd_point(dst0, dst1)], dim=-2)
    return _solve_affine(dst, src) if inv else _solve_affine(src, dst)


def affine_transform(pts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (2, 3) affine, or one per batch (B, 2, 3), applied to points
    (..., 2) (transforms.py:93-96)."""
    return pts @ t[..., :2].transpose(-1, -2) + t[..., None, :, 2]


def transform_preds(coords: torch.Tensor, center, scale,
                    output_size) -> torch.Tensor:
    """Heatmap coordinates (..., K, 2) -> image coordinates through the
    inverse affine (transforms.py:50-55)."""
    trans = get_affine_transform(center, scale, 0.0, output_size, inv=True)
    return affine_transform(coords, trans.to(coords.device))


def crop(images: torch.Tensor, center, scale, output_size,
         rot: float = 0.0) -> torch.Tensor:
    """Batched transforms.py:114-122 ``crop``: warp images (B, H, W[, C])
    through the centre/scale/rotation affine to (out_h, out_w).  center
    (B, 2) or (2,); scale (B, 2), (2,), (B,) or a number."""
    b = images.shape[0]
    dev = images.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    center = center.expand(b, 2) if center.dim() == 1 else center
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    if scale.dim() == 0:
        scale = scale.expand(b, 2)
    elif scale.dim() == 1 and scale.shape[0] == 2:
        scale = scale.expand(b, 2)
    elif scale.dim() == 1:
        scale = torch.stack([scale, scale], dim=-1)
    # warpAffine samples the output through the inverse map
    M = get_affine_transform(center, scale, rot, output_size, inv=True)
    return affine_sample_sized(images, M, int(output_size[1]),
                               int(output_size[0]))


def affine_sample_sized(images: torch.Tensor, matrices: torch.Tensor,
                        out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear inverse-warp sampling to an explicit output size:
    out[y, x] = in[M @ (x, y, 1)], each tap outside the image zero (cv2
    BORDER_CONSTANT blends the border with the constant).  images
    (B, H, W[, C]); matrices (B, 2, 3)."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    b, h, w, c = images.shape
    dev = images.device
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    M = matrices.to(torch.float32)
    sx = (M[:, 0, 0, None, None] * xs + M[:, 0, 1, None, None] * ys
          + M[:, 0, 2, None, None])
    sy = (M[:, 1, 0, None, None] * xs + M[:, 1, 1, None, None] * ys
          + M[:, 1, 2, None, None])
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = sx - x0
    fy = sy - y0
    flat = images.to(torch.float32).reshape(b, h * w, c)

    def gat(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (torch.clamp(yy, 0, h - 1) * w
               + torch.clamp(xx, 0, w - 1)).reshape(b, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(
            b, out_h, out_w, c)
        return vals * valid[..., None]

    out = (gat(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
           + gat(y0, x0 + 1) * (fx * (1 - fy))[..., None]
           + gat(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
           + gat(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    return out[..., 0] if squeeze else out
