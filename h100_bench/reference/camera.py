"""A frozen copy, for the benchmark's plain reference, of the port's
core/camera.py.
It imports nothing of the port, so a later change to the port's code leaves
it as it is.  The original's first line:

Camera model and rotation helpers for the SPEED pipeline (torch port).

Conventions follow the JAX package: scalar-first quaternions ``(w, x, y,
z)``; ``quat_to_rotmat`` returns the active rotation with
``x_cam = R @ x_body + t``; every function takes arbitrary leading batch
dimensions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# --- SPEED camera constants (reference: utils.py:24-39) ---------------------
SPEED_FX_M = 0.0176          # focal length [m]
SPEED_FY_M = 0.0176
SPEED_NU = 1920              # horizontal pixels
SPEED_NV = 1200              # vertical pixels
SPEED_PPX = 5.86e-6          # pixel pitch [m/pixel]
SPEED_FPX = SPEED_FX_M / SPEED_PPX   # ~3003.413 px
SPEED_FPY = SPEED_FY_M / SPEED_PPX

SPEED_K = np.array(
    [[SPEED_FPX, 0.0, SPEED_NU / 2],
     [0.0, SPEED_FPY, SPEED_NV / 2],
     [0.0, 0.0, 1.0]],
    dtype=np.float64,
)

# LINEMOD camera (reference: pnp.py:8-10), for the PVNet family.
LINEMOD_K = np.array(
    [[572.4114, 0.0, 325.2611],
     [0.0, 573.57043, 242.04899],
     [0.0, 0.0, 1.0]],
    dtype=np.float64,
)


@lru_cache(maxsize=8)
def speed_k(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """:data:`SPEED_K` as a tensor on ``device``, copied once per (dtype,
    device): a copy from host memory on every call would make the host
    wait for the queued kernels.  Shared: do not write to it."""
    return torch.as_tensor(SPEED_K, dtype=dtype, device=device)


@lru_cache(maxsize=8)
def linemod_k(dtype: torch.dtype = torch.float32, device=None
              ) -> torch.Tensor:
    """:data:`LINEMOD_K` as a tensor on ``device``, copied once per
    (dtype, device), as :func:`speed_k`.  Shared: do not write to it."""
    return torch.as_tensor(LINEMOD_K, dtype=dtype, device=device)


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. q: (..., 4)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> active rotation matrix R, batched."""
    q = normalize_quat(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [torch.stack([r00, r01, r02], dim=-1),
         torch.stack([r10, r11, r12], dim=-1),
         torch.stack([r20, r21, r22], dim=-1)],
        dim=-2,
    )


def quat_to_dcm(q: torch.Tensor) -> torch.Tensor:
    """Passive DCM, the reference ``quat2dcm`` (utils.py:68-95): the
    transpose of :func:`quat_to_rotmat`, batched."""
    return quat_to_rotmat(q).transpose(-1, -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w,x,y,z), batched, branch-free
    (largest-pivot candidate of four, sign canonicalized to w >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx0 = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                      dim=-1)
    qy0 = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                      dim=-1)
    qz0 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                      dim=-1)

    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(best == 0, qw0,
                    torch.where(best == 1, qx0,
                                torch.where(best == 2, qy0, qz0)))
    q = normalize_quat(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def _skew_unit(k: torch.Tensor) -> torch.Tensor:
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    return torch.stack(
        [torch.stack([zero, -kz, ky], dim=-1),
         torch.stack([kz, zero, -kx], dim=-1),
         torch.stack([-ky, kx, zero], dim=-1)],
        dim=-2,
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> rotation matrix (cv2.Rodrigues forward), batched.
    Taylor-safe at theta = 0."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    safe_theta = torch.where(small, 1.0, theta)
    K = _skew_unit(rvec / safe_theta)
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1 - torch.cos(th)) * torch.matmul(K, K)
    R_small = eye + th * K
    return torch.where(small[..., None], R_small, R)


def rotmat_to_rvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle (cv2.Rodrigues inverse), batched."""
    q = rotmat_to_quat(R)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vnorm[..., 0], w)
    axis = v / torch.where(vnorm < 1e-12, 1.0, vnorm)
    return axis * theta[..., None]


def project_points(points_3d: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """Project body-frame 3D points to pixel coordinates.

    points_3d: (..., N, 3); R: (..., 3, 3); t: (..., 3); K: (3, 3) or
    broadcastable.  Returns (..., N, 2).
    """
    p_cam = torch.einsum('...ij,...nj->...ni', R, points_3d) + t[..., None, :]
    return project_camera_points(p_cam, K)


def project_camera_points(p_cam: torch.Tensor, K: torch.Tensor
                          ) -> torch.Tensor:
    """The pinhole projection of camera-frame points: (..., N, 3) ->
    (..., N, 2) pixel coordinates; K: (3, 3) or broadcastable."""
    xy = p_cam[..., :2] / p_cam[..., 2:3]
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = fx[..., None] * xy[..., 0] + cx[..., None]
    v = fy[..., None] * xy[..., 1] + cy[..., None]
    return torch.stack([u, v], dim=-1)


def pose_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R|t] 3x4 pose matrix (the reference's ``pose_pred`` layout,
    pnp.py:90)."""
    return torch.cat([R, t[..., :, None]], dim=-1)
