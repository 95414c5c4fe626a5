"""Reference-layout dataset exporter (torch port of the JAX package's
``data/speed_gen.py``).

Writes a synthetic dataset in the on-disk layout the reference stack
consumes, so that the production chain — pickles -> packed shard ->
``cli/train --train-shard`` -> ``cli/evaluate`` -> ``cli/submit`` CSV —
runs end to end from disk (``cli/dress_rehearsal.py``):

* ``images/train|test|real_test/img%06d.jpg`` grey frames (SPEED's
  1920x1200 JPEGs; the size is a parameter for small tests).  Synthetic
  names are exactly 13 characters (``img000001.jpg``) because the
  reference's mixed loader routes records by that length
  (data_load5.py:110-113); ``real_test`` names are longer on purpose.
* ``train.json`` / ``test.json`` / ``real_test.json`` competition metadata
  (utils.py:42-65: ``filename``, ``q_vbs2tango``, ``r_Vo2To_vbs_true``;
  the unlabelled split carries file names only).
* ``train.pkl`` / ``test.pkl`` / ``real_test.pkl`` record databases with
  the ``des`` schema of data_load4.py:90-101: ``rgb_pth``, ``bbox``,
  ``sift`` (2D keypoints), ``sift3d`` (model points), ``K``, ``qua``,
  ``RT``; ``real_test.pkl`` has no ``qua``/``RT``/``sift``, like the
  leaderboard split.

The frames are the synthetic SPEED stand-in of ``data/synthetic.py``
(per-keypoint-distinct Gaussian blobs, poses from the SPEED depth
distribution), rendered in batches on ``device`` and cast to uint8 there,
so that a quarter of the bytes crosses to the host.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.data import synthetic
from esa_pose_estimation_tpu_torch.utils.artifact import target_device
from esa_pose_estimation_tpu_torch.utils.seeding import generator as seeded


def render_split(generator: torch.Generator | None, points_3d: torch.Tensor,
                 n: int, height: int, width: int, batch: int,
                 poses: tuple[np.ndarray, np.ndarray] | None = None):
    """Yield ``(image uint8 (H, W), bbox, kp2d, quat, trans)`` (numpy) per
    frame, rendered ``batch`` frames at a time on ``points_3d``'s device.
    ``poses`` = (quat (n, 4), trans (n, 3)) replaces the generator's
    draws."""
    dev = points_3d.device
    for b0 in range(0, n, batch):
        nb = min(batch, n - b0)
        if poses is None:
            q, t = synthetic.random_pose(generator, nb, device=dev)
        else:
            q = torch.as_tensor(poses[0][b0:b0 + nb], dtype=torch.float32,
                                device=dev)
            t = torch.as_tensor(poses[1][b0:b0 + nb], dtype=torch.float32,
                                device=dev)
        s = synthetic.sample_from_pose(q, t, points_3d, height, width)
        image = torch.clamp(s.image, 0, 255).to(torch.uint8).cpu().numpy()
        bbox, kp, q, t = (a.cpu().numpy() for a in
                          (s.bbox, s.keypoints_2d, s.quat, s.trans))
        for j in range(nb):
            yield image[j], bbox[j], kp[j], q[j], t[j]


def rt_from(quat: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """(3, 4) [R|t] of one pose."""
    R = camera.quat_to_rotmat(torch.as_tensor(quat,
                                              dtype=torch.float32)).numpy()
    return np.concatenate([R, np.reshape(trans, (3, 1))], axis=1)


def export_reference_layout(root: str, n_train: int = 480,
                            n_test: int = 64, n_real_test: int = 32,
                            height: int = 1200, width: int = 1920,
                            n_kp: int = 30, seed: int = 0, batch: int = 8,
                            jpeg_quality: int = 95,
                            device: str | torch.device = 'cuda') -> dict:
    """Generate the dataset; returns the paths of everything written.
    Each split draws its poses from its own generator, seeded from
    ``seed`` and the split's index."""
    from PIL import Image

    dev = target_device(device, 'speed_gen')
    points_3d = synthetic.spacecraft_points(device=dev, n=n_kp)
    sift3d = points_3d.cpu().numpy()
    K = synthetic.scaled_intrinsics(height, width).numpy()
    splits = {'train': n_train, 'test': n_test, 'real_test': n_real_test}
    out = {'root': root}
    for si, (split, n) in enumerate(splits.items()):
        img_dir = os.path.join(root, 'images', split)
        os.makedirs(img_dir, exist_ok=True)
        labeled = split != 'real_test'
        meta, des_list = [], []
        for idx, (img, bbox, kp2d, quat, trans) in enumerate(
                render_split(seeded(dev, seed, si), points_3d, n, height,
                             width, batch)):
            # longer than 13 characters on purpose: the length rule must
            # route these as real captures
            name = (f'img{idx + 1:06d}real.jpg' if split == 'real_test'
                    else f'img{idx + 1:06d}.jpg')
            Image.fromarray(img, mode='L').save(
                os.path.join(img_dir, name), quality=jpeg_quality)
            entry: dict = {'filename': name}
            if labeled:
                entry['q_vbs2tango'] = [float(v) for v in quat]
                entry['r_Vo2To_vbs_true'] = [float(v) for v in trans]
            meta.append(entry)
            des = {'rgb_pth': name,
                   'bbox': bbox.astype(np.float32),
                   'sift3d': sift3d,
                   'K': K.astype(np.float32)}
            if labeled:
                des['sift'] = kp2d.astype(np.float32)
                des['qua'] = quat.astype(np.float32)
                des['RT'] = rt_from(quat, trans).astype(np.float32)
            des_list.append(des)

        json_path = os.path.join(root, f'{split}.json')
        with open(json_path, 'w') as f:
            json.dump(meta, f)
        pkl_path = os.path.join(root, f'{split}.pkl')
        with open(pkl_path, 'wb') as f:
            pickle.dump(des_list, f)
        out[f'{split}_json'] = json_path
        out[f'{split}_pkl'] = pkl_path
        out[f'{split}_images'] = img_dir
    return out


def main(argv=None) -> dict:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', required=True)
    ap.add_argument('--n-train', type=int, default=480)
    ap.add_argument('--n-test', type=int, default=64)
    ap.add_argument('--n-real-test', type=int, default=32)
    ap.add_argument('--height', type=int, default=1200)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--n-kp', type=int, default=30)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--device', default='cuda',
                    help="where the frames are rendered: 'cuda' (default) "
                         "or 'cpu'")
    args = ap.parse_args(argv)
    out = export_reference_layout(
        args.root, args.n_train, args.n_test, args.n_real_test, args.height,
        args.width, args.n_kp, args.seed, args.batch, device=args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
