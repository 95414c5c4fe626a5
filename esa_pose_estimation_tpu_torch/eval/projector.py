"""Per-dataset camera registry and projection (torch port of the JAX
package's ``eval/projector.py``).

Replaces the reference's ``Projector`` (evaluation.py:172-227 /
lib/utils/base_utils.py), which hardcodes intrinsics and paths per dataset
name, with a registry over numpy projection: the per-sample eval loops
call it on (N <= 32, 3) arrays on the host.
"""

from __future__ import annotations

import numpy as np

from esa_pose_estimation_tpu_torch.core import camera

# named intrinsics (evaluation.py:172-227 plus the SPEED camera)
CAMERAS: dict[str, np.ndarray] = {
    'esa': camera.SPEED_K,
    'speed': camera.SPEED_K,
    'linemod': camera.LINEMOD_K,
    'blender': np.array([[700.0, 0.0, 320.0],
                         [0.0, 700.0, 240.0],
                         [0.0, 0.0, 1.0]]),
}


def register_camera(name: str, K: np.ndarray) -> None:
    CAMERAS[name] = np.asarray(K, np.float64)


class Projector:
    """``Projector.project(pts, RT, 'esa')`` parity (demo.py:279-282)."""

    def intrinsics(self, camera_type: str) -> np.ndarray:
        return CAMERAS[camera_type]

    def project(self, points_3d, pose, camera_type: str) -> np.ndarray:
        """points_3d (N, 3); pose (3, 4) [R|t] -> (N, 2) f32 pixels."""
        K = np.asarray(CAMERAS[camera_type], np.float64)
        pose = np.asarray(pose, np.float64)
        cam = np.asarray(points_3d, np.float64) @ pose[:3, :3].T \
            + pose[:3, 3]
        uvw = cam @ K.T
        return (uvw[:, :2] / uvw[:, 2:3]).astype(np.float32)
