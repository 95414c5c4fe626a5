"""External-renderer driver for synthetic LINEMOD data (torch port of the
JAX package's ``utils/render_driver.py``).

The reference's Blender orchestration (render_utils.py:161-274
``Renderer`` / ``YCBRenderer``): sample poses from the training-pose
distribution, prepare a background-image list, launch an external
renderer per class with the reference's command contract (``<exe>
<blend> --background --python <backend.py> -- --input <obj> --output_dir
<dir> --bg_imgs <npy> --poses_path <npy>``), convert its depth outputs,
and fan the classes out over a process pool (render_utils.py:263-274).

* The renderer executable is given (``renderer_exe``), not a fixed path.
  Without one, :meth:`ExternalRenderer.run_fallback` renders depth-shaded
  frames and masks with the port's rasterizer (``utils/render.py``) on
  ``device`` (the card unless told otherwise), batches of poses per call.
* Depth conversion takes the reference's EXR side-files (with the
  optional OpenEXR package) and ``.npy`` dumps, both to the reference's
  binary foreground PNG (the ``depth != 1`` rule, render_utils.py:
  211-222).
* Poses are stored in the reference layout: ``np.save(poses_path,
  concat([eulers, translations], -1))``, (N, 6) (render_utils.py:
  120-157).
* :func:`multi_render` starts its workers with ``spawn``: a child forked
  from a process that has initialised CUDA cannot use the card.
"""

from __future__ import annotations

import glob
import multiprocessing
import os
import subprocess
from dataclasses import dataclass, field

import numpy as np

# the reference's per-dataset render intrinsics (render_utils.py:162-171)
RENDER_K = {
    'linemod': np.array([[572.4114, 0., 325.2611],
                         [0., 573.57043, 242.04899],
                         [0., 0., 1.]]),
    'blender': np.array([[700., 0., 320.],
                         [0., 700., 240.],
                         [0., 0., 1.]]),
}
_FRAME_HW = (480, 640)
_FALLBACK_BATCH = 16


def prepare_background_list(image_dir: str, out_path: str,
                            min_size: int = 500) -> list[str]:
    """The usable background images (render_utils.py:184-198: both sides
    above ``min_size``), saved as ``.npy`` and returned."""
    from PIL import Image

    paths = []
    for p in sorted(glob.glob(os.path.join(image_dir, '*'))):
        try:
            with Image.open(p) as img:
                w, h = img.size
        except OSError:             # not an image PIL can open
            continue
        if w > min_size and h > min_size:
            paths.append(p)
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    np.save(out_path, np.asarray(paths))
    return paths


def euler_to_rotmat(euler_xyz: np.ndarray) -> np.ndarray:
    """R = Rz(z) @ Ry(y) @ Rx(x), the inverse of :func:`euler_from_rotmat`."""
    x, y, z = float(euler_xyz[0]), float(euler_xyz[1]), float(euler_xyz[2])
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def euler_from_rotmat(Rs: np.ndarray) -> np.ndarray:
    """XYZ Euler angles of (N, 3, 3) rotations (the pose layout the
    Blender backend reads)."""
    sy = np.sqrt(Rs[:, 0, 0] ** 2 + Rs[:, 1, 0] ** 2)
    singular = sy < 1e-6
    x = np.where(singular, np.arctan2(-Rs[:, 1, 2], Rs[:, 1, 1]),
                 np.arctan2(Rs[:, 2, 1], Rs[:, 2, 2]))
    y = np.arctan2(-Rs[:, 2, 0], sy)
    z = np.where(singular, 0.0, np.arctan2(Rs[:, 1, 0], Rs[:, 0, 0]))
    return np.stack([x, y, z], axis=-1)


@dataclass
class ExternalRenderer:
    """One class's render job (render_utils.py:161-261)."""
    class_type: str
    obj_path: str
    output_dir: str
    poses_path: str
    bg_imgs_path: str
    renderer_exe: str | None = None       # e.g. a blender binary
    blend_file: str = ''
    backend_script: str = ''
    n_poses: int = 100
    min_dist: float = 0.4
    max_dist: float = 1.2
    seed: int = 0
    camera_type: str = 'linemod'
    extra_args: tuple[str, ...] = field(default_factory=tuple)
    device: str = 'cuda'                  # of the fallback rasterizer

    def sample_poses(self) -> np.ndarray:
        """(N, 6) [euler_xyz | translation] from the pose sphere
        (render_utils.py run(), step 2), saved in the reference layout."""
        from esa_pose_estimation_tpu_torch.utils import render as render_mod

        Rs, ts = render_mod.sample_poses(self.n_poses, self.min_dist,
                                         self.max_dist, seed=self.seed)
        poses = np.concatenate([euler_from_rotmat(np.asarray(Rs)),
                                np.asarray(ts)], axis=-1)
        os.makedirs(os.path.dirname(self.poses_path) or '.', exist_ok=True)
        np.save(self.poses_path, poses)
        return poses

    def command(self) -> list[str]:
        """The reference's command contract (render_utils.py:255-257)."""
        if not self.renderer_exe:
            raise ValueError('command() needs renderer_exe')
        cmd = [self.renderer_exe]
        if self.blend_file:
            cmd.append(self.blend_file)
        cmd += ['--background']
        if self.backend_script:
            cmd += ['--python', self.backend_script]
        cmd += ['--', '--input', self.obj_path,
                '--output_dir', self.output_dir,
                '--bg_imgs', self.bg_imgs_path,
                '--poses_path', self.poses_path]
        cmd += list(self.extra_args)
        return cmd

    def convert_depth_outputs(self) -> int:
        """Depth side-files -> the reference's binary foreground PNG
        (``depth != 1``, render_utils.py:206-222).  EXR needs the optional
        OpenEXR package; ``.npy`` always converts."""
        from PIL import Image

        n = 0
        for npy in glob.glob(os.path.join(self.output_dir, '*_depth.npy')):
            dmap = np.load(npy)
            png = npy.replace('_depth.npy', '_depth.png')
            Image.fromarray(((dmap != 1).astype(np.uint8)) * 255).save(png)
            os.remove(npy)
            n += 1
        for exr in glob.glob(os.path.join(self.output_dir, '*.exr')):
            try:
                import Imath
                import OpenEXR
            except ImportError:
                break                     # the EXRs stay: no converter here
            img = OpenEXR.InputFile(exr)
            dw = img.header()['dataWindow']
            w, h = dw.max.x - dw.min.x + 1, dw.max.y - dw.min.y + 1
            raw = img.channels('B', Imath.PixelType(Imath.PixelType.FLOAT))
            dmap = np.frombuffer(raw[0], np.float32).reshape(h, w)
            png = exr.replace('.png0001.exr', '.png')
            Image.fromarray(((dmap != 1).astype(np.uint8)) * 255).save(png)
            img.close()
            os.remove(exr)
            n += 1
        return n

    def run_fallback(self) -> int:
        """No external renderer: depth-shaded frames and masks from the
        port's rasterizer on ``device``, in the same layout (``<i>.png`` +
        ``<i>_depth.png``)."""
        import torch
        from PIL import Image

        from esa_pose_estimation_tpu_torch.utils import render as render_mod
        from esa_pose_estimation_tpu_torch.utils.artifact import (
            target_device,
        )

        dev = target_device(self.device, 'render_driver')
        poses = np.load(self.poses_path)
        verts, faces = _load_mesh(self.obj_path)
        h, w = _FRAME_HW
        os.makedirs(self.output_dir, exist_ok=True)
        vt = torch.as_tensor(verts, device=dev)
        ft = torch.as_tensor(faces, device=dev)
        Kt = torch.as_tensor(RENDER_K[self.camera_type], dtype=torch.float32,
                             device=dev)
        for b0 in range(0, len(poses), _FALLBACK_BATCH):
            chunk = poses[b0:b0 + _FALLBACK_BATCH]
            R = np.stack([euler_to_rotmat(p[:3]) for p in chunk])
            t = np.asarray(chunk[:, 3:6], np.float32)
            mask, depth = render_mod.rasterize(
                vt, ft, torch.as_tensor(R, device=dev),
                torch.as_tensor(t, device=dev), Kt, h, w)
            mask, depth = mask.cpu().numpy(), depth.cpu().numpy()
            for j, pose in enumerate(chunk):
                zc = float(pose[5])
                finite = np.where(np.isfinite(depth[j]), depth[j], zc)
                shade = np.clip(1.0 - (finite - (zc - 0.2)) / 0.4, 0.0, 1.0)
                img = (shade * mask[j] * 255).astype(np.uint8)
                i = b0 + j
                Image.fromarray(img).save(
                    os.path.join(self.output_dir, f'{i}.png'))
                Image.fromarray((mask[j] * 255).astype(np.uint8)).save(
                    os.path.join(self.output_dir, f'{i}_depth.png'))
        return len(poses)

    def run(self) -> int:
        """Sample poses, render, convert depth (render_utils.py:243-261).
        Returns the number of rendered frames in ``output_dir``."""
        if not os.path.exists(self.poses_path):
            self.sample_poses()
        os.makedirs(self.output_dir, exist_ok=True)
        if self.renderer_exe:
            subprocess.run(self.command(), check=True)
            self.convert_depth_outputs()
        else:
            self.run_fallback()
        return len([p for p in glob.glob(os.path.join(self.output_dir,
                                                      '*.png'))
                    if not p.endswith('_depth.png')])


def _load_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """The fallback's mesh: ``.npz`` with ``vertices`` and ``faces``, or
    ``.ply`` vertices triangulated by their convex hull (the silhouette is
    right for the masks and depths the DB builders read; a concave mesh
    should come as ``.npz``)."""
    if path.endswith('.npz'):
        with np.load(path) as d:
            return (d['vertices'].astype(np.float32),
                    d['faces'].astype(np.int32))
    from scipy.spatial import ConvexHull

    from esa_pose_estimation_tpu_torch.data.linemod import load_ply_vertices
    verts = load_ply_vertices(path).astype(np.float32)
    return verts, ConvexHull(verts).simplices.astype(np.int32)


def _run_one(job: ExternalRenderer) -> tuple[str, int]:
    return job.class_type, job.run()


def multi_render(jobs: list[ExternalRenderer],
                 processes: int = 2) -> dict[str, int]:
    """Fan render jobs over a pool of ``spawn``ed processes
    (render_utils.py:263-274 multi_thread_render)."""
    if len(jobs) <= 1 or processes <= 1:
        return dict(_run_one(j) for j in jobs)
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(processes=processes) as pool:
        return dict(pool.map(_run_one, jobs))
