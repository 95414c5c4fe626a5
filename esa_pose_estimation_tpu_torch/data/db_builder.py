"""Offline LINEMOD pose-database builders and the fuse-set composer
(port of the JAX package's ``data/db_builder.py``; host numpy, as there).

Writes the per-class pickle databases that ``data/linemod.py`` and
``cli/train_linemod --pkl-dir --image-root`` read (``{cls}_real.pkl``,
``{cls}_render.pkl``, ``{cls}_fuse.pkl``, ``{cls}_train/test.pkl`` and
``occ/{cls}_real.pkl``) from an on-disk LINEMOD layout.  Re-designed from
the reference's ``LineModImageDB`` / ``OcclusionLineModImageDB``
collectors (lib/utils/data_utils.py:174-546, 566-645):

* records carry the fields the training path reads (data_load3.py:
  140-259): ``rgb_pth / dpt_pth / bbox / sift / sift_3d / K / RT /
  cls_typ / rnd_typ``; the class constants the reference copies into
  every record come from ``LineModModelDB`` instead;
* canonical keypoints are FPS points of the registered mesh
  (``LineModModelDB.get_farthest_3d``), and ``bbox`` is the mask's box
  (mask_to_bbox, data_load3.py:17-38), taken here;
* :func:`compose_fuse_set` also makes fuse composites, which the
  reference only reads: per-class renders pasted onto backgrounds in
  occlusion order, with the ``begins`` / ``poses`` info pickles of the
  K-shift convention (data_utils.py:344-348).

``utils/render_driver.py`` writes the ``renders/{cls}/`` frames that
:func:`build_render_db` reads.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from esa_pose_estimation_tpu_torch.core.camera import LINEMOD_K
from esa_pose_estimation_tpu_torch.data.linemod import (
    FUSE_CLS_ORDER,
    LineModModelDB,
)


def project_K(pts_3d: np.ndarray, RT: np.ndarray, K: np.ndarray
              ) -> np.ndarray:
    """Pinhole projection (base_utils.py:project_K semantics)."""
    cam = pts_3d @ np.asarray(RT)[:, :3].T + np.asarray(RT)[:, 3:].T
    px = cam @ np.asarray(K).T
    return (px[:, :2] / px[:, 2:]).astype(np.float32)


def mask_to_bbox(mask: np.ndarray) -> np.ndarray:
    """[x1, y1, x2, y2] corners of the nonzero mask region
    (data_load3.py:17-38 role; empty mask -> zeros)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def _save_pkl(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(obj, f)


def _read_img(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def read_rot_tra(rot_path: str, tra_path: str) -> np.ndarray:
    """LINEMOD_ORIG ``rot{k}.rot`` / ``tra{k}.tra`` text pose files
    (data_utils.py read_pose role): first line is the dims header, then
    the row-major values; translation is in cm -> meters (/100)."""
    def _vals(path):
        with open(path) as f:
            lines = [ln for ln in f.read().split('\n') if ln.strip()]
        return np.array(' '.join(lines[1:]).split(), np.float64)

    R = _vals(rot_path).reshape(3, 3)
    t = _vals(tra_path).reshape(3, 1) / 100.0
    return np.concatenate([R, t], axis=1).astype(np.float32)


def _record(rgb_pth: str, dpt_pth: str, RT: np.ndarray, K: np.ndarray,
            cls_name: str, rnd_typ: str, kp3d: np.ndarray,
            mask: np.ndarray) -> dict:
    return {
        'rgb_pth': rgb_pth,
        'dpt_pth': dpt_pth,
        'RT': np.asarray(RT, np.float32),
        'K': np.asarray(K, np.float32),
        'cls_typ': cls_name,
        'rnd_typ': rnd_typ,
        'sift_3d': np.asarray(kp3d, np.float32),
        'sift': project_K(kp3d, RT, K),
        'bbox': mask_to_bbox(mask),
    }


def build_real_db(root: str, cls_name: str, db: LineModModelDB,
                  n_kp: int = 32, rgb_dir: str | None = None,
                  mask_dir: str | None = None, pose_dir: str | None = None,
                  out_dir: str | None = None) -> list[dict]:
    """Collect the real-image record set -> ``{cls}_real.pkl``
    (collect_real_set_info, data_utils.py:276-312).

    Layout: ``{root}/{cls}/JPEGImages/{k:06}.jpg``, masks
    ``{root}/{cls}/mask/{k:04}.png``, poses ``{pose_dir}/rot{k}.rot`` +
    ``tra{k}.tra`` (LINEMOD_ORIG convention).  Record index k is dense
    from 0.  Poses are stored as read — the reference additionally
    rotates ORIG poses into the blender frame via per-mesh alignment
    (PoseTransformer); supply pre-aligned poses or align the meshes.
    """
    rgb_dir = rgb_dir or os.path.join(cls_name, 'JPEGImages')
    mask_dir = mask_dir or os.path.join(cls_name, 'mask')
    pose_dir = pose_dir or os.path.join(cls_name, 'data')
    kp3d = db.get_farthest_3d(cls_name, n_kp)
    n = len([f for f in os.listdir(os.path.join(root, rgb_dir))
             if f.endswith(('.jpg', '.png'))])
    records = []
    for k in range(n):
        rgb_pth = os.path.join(rgb_dir, f'{k:06d}.jpg')
        dpt_pth = os.path.join(mask_dir, f'{k:04d}.png')
        RT = read_rot_tra(os.path.join(root, pose_dir, f'rot{k}.rot'),
                          os.path.join(root, pose_dir, f'tra{k}.tra'))
        mask = _read_img(os.path.join(root, dpt_pth))
        if mask.ndim == 3:
            mask = mask.sum(2)
        records.append(_record(rgb_pth, dpt_pth, RT, LINEMOD_K, cls_name,
                               'real', kp3d, mask))
    _save_pkl(records, os.path.join(out_dir or root,
                                    f'{cls_name}_real.pkl'))
    return records


def build_render_db(root: str, cls_name: str, db: LineModModelDB,
                    n_kp: int = 32, render_dir: str | None = None,
                    out_dir: str | None = None, fmt: str = 'jpg'
                    ) -> list[dict]:
    """Collect the synthetic-render record set -> ``{cls}_render.pkl``
    (collect_render_set_info, data_utils.py:243-274).

    Layout: ``{root}/renders/{cls}/{k}.jpg`` + ``{k}_depth.png`` +
    ``{k}_RT.pkl`` ({'RT': (3,4)}), k dense from 0.
    """
    render_dir = render_dir or os.path.join('renders', cls_name)
    kp3d = db.get_farthest_3d(cls_name, n_kp)
    base = os.path.join(root, render_dir)
    n = len([f for f in os.listdir(base) if f.endswith('_RT.pkl')])
    records = []
    for k in range(n):
        with open(os.path.join(base, f'{k}_RT.pkl'), 'rb') as f:
            meta = pickle.load(f)
        RT = np.asarray(meta['RT'], np.float32)
        K = np.asarray(meta.get('K', LINEMOD_K), np.float64)
        dpt_pth = os.path.join(render_dir, f'{k}_depth.png')
        depth = _read_img(os.path.join(root, dpt_pth))
        records.append(_record(
            os.path.join(render_dir, f'{k}.{fmt}'), dpt_pth, RT, K,
            cls_name, 'render', kp3d, depth > 0))
    _save_pkl(records, os.path.join(out_dir or root,
                                    f'{cls_name}_render.pkl'))
    return records


def build_fuse_db(root: str, cls_name: str, db: LineModModelDB,
                  n_kp: int = 32, fuse_dir: str = 'fuse',
                  out_dir: str | None = None, min_px: int = 400
                  ) -> list[dict]:
    """Collect the fuse-composite record set -> ``{cls}_fuse.pkl``
    (collect_fuse_info, data_utils.py:328-361): skip composites with
    fewer than ``min_px`` visible pixels of this class, shift the
    principal point by the stored per-class paste offset
    (K[0,2] += begins[cls,1]; K[1,2] += begins[cls,0]).
    """
    cls_idx = FUSE_CLS_ORDER.index(cls_name)
    kp3d = db.get_farthest_3d(cls_name, n_kp)
    base = os.path.join(root, fuse_dir)
    n = len([f for f in os.listdir(base) if f.endswith('_info.pkl')])
    records = []
    for k in range(n):
        mask = _read_img(os.path.join(base, f'{k}_mask.png'))
        cls_mask = mask == cls_idx + 1
        if cls_mask.sum() < min_px:
            continue
        with open(os.path.join(base, f'{k}_info.pkl'), 'rb') as f:
            begins, poses = pickle.load(f)
        K = LINEMOD_K.copy()
        K[0, 2] += begins[cls_idx, 1]
        K[1, 2] += begins[cls_idx, 0]
        records.append(_record(
            os.path.join(fuse_dir, f'{k}_rgb.jpg'),
            os.path.join(fuse_dir, f'{k}_mask.png'),
            np.asarray(poses[cls_idx], np.float32), K, cls_name, 'fuse',
            kp3d, cls_mask))
    _save_pkl(records, os.path.join(out_dir or root,
                                    f'{cls_name}_fuse.pkl'))
    return records


def build_split_pkls(records: list[dict], root: str, cls_name: str,
                     test_fraction: float = 0.5, seed: int = 0,
                     out_dir: str | None = None
                     ) -> tuple[list, list]:
    """Write ``{cls}_train.pkl`` / ``{cls}_test.pkl`` path lists over the
    real record set (the data2/ split convention data_load3.py:104-112:
    entries are tuples whose first element's numeric stem indexes
    ``{cls}_real.pkl``)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(records))
    n_test = int(round(len(records) * test_fraction))
    test_idx = set(order[:n_test].tolist())
    train, test = [], []
    for i, rec in enumerate(records):
        entry = (str(rec['rgb_pth']),)
        (test if i in test_idx else train).append(entry)
    out = out_dir or root
    _save_pkl(train, os.path.join(out, f'{cls_name}_train.pkl'))
    _save_pkl(test, os.path.join(out, f'{cls_name}_test.pkl'))
    return train, test


def build_occlusion_db(root: str, cls_name: str, db: LineModModelDB,
                       n_kp: int = 32, rgb_dir: str = 'RGB-D/rgb_noseg',
                       mask_dir: str | None = None,
                       pose_reader=None, out_dir: str | None = None
                       ) -> list[dict]:
    """Collect OCCLUSION_LINEMOD eval records -> ``occ/{cls}_real.pkl``
    (OcclusionLineModImageDB.collect_real_set_info,
    data_utils.py:566-645).  Layout: ``{root}/RGB-D/rgb_noseg/
    color_{k:05}.png``, masks ``{root}/masks/{cls}/{k}.png``.  Poses come
    from ``pose_reader(k) -> (3,4) | None`` (None skips the frame, the
    reference's empty-info rule); default reads rot/tra pairs from
    ``{root}/poses/{Cls}/``.
    """
    mask_dir = mask_dir or os.path.join('masks', cls_name)
    kp3d = db.get_farthest_3d(cls_name, n_kp)
    if pose_reader is None:
        pdir = os.path.join(root, 'poses',
                            cls_name[0].upper() + cls_name[1:])

        def pose_reader(k):
            rot = os.path.join(pdir, f'rot{k}.rot')
            tra = os.path.join(pdir, f'tra{k}.tra')
            if not (os.path.exists(rot) and os.path.exists(tra)):
                return None
            return read_rot_tra(rot, tra)

    n = len(os.listdir(os.path.join(root, rgb_dir)))
    records = []
    for k in range(n):
        RT = pose_reader(k)
        if RT is None:
            continue
        dpt_pth = os.path.join(mask_dir, f'{k}.png')
        mask = _read_img(os.path.join(root, dpt_pth))
        if mask.ndim == 3:
            mask = mask.sum(2)
        records.append(_record(
            os.path.join(rgb_dir, f'color_{k:05d}.png'), dpt_pth, RT,
            LINEMOD_K, cls_name, 'real', kp3d, mask))
    _save_pkl(records, os.path.join(out_dir or root, 'occ',
                                    f'{cls_name}_real.pkl'))
    return records


def compose_fuse_set(root: str, class_renders: dict[str, str],
                     n_images: int, out_dir: str = 'fuse',
                     backgrounds: list[str] | None = None,
                     frame_hw: tuple[int, int] = (480, 640),
                     max_shift: int = 120, seed: int = 0) -> int:
    """Create a fuse composite set the reference only consumes: for each
    output image, paste one render of every class in ``class_renders``
    (``{render_dir}/{k}.jpg`` + ``{k}_depth.png`` + ``{k}_RT.pkl``) onto a
    background at a random shift, later FUSE_CLS_ORDER classes occluding
    earlier ones.  Writes ``{k}_rgb.jpg``, ``{k}_mask.png`` (per-class
    indices, FUSE_CLS_ORDER + 1) and ``{k}_info.pkl`` = (begins (C, 2)
    [row, col], poses) with the K-shift convention of
    data_utils.py:344-348.  Returns the number of composites written.
    """
    from PIL import Image
    rng = np.random.default_rng(seed)
    h, w = frame_hw
    base = os.path.join(root, out_dir)
    os.makedirs(base, exist_ok=True)
    counts = {c: len([f for f in os.listdir(os.path.join(root, d))
                      if f.endswith('_RT.pkl')])
              for c, d in class_renders.items()}
    n_cls = len(FUSE_CLS_ORDER)
    for k in range(n_images):
        if backgrounds:
            bg = np.asarray(Image.open(
                backgrounds[rng.integers(len(backgrounds))])
                .convert('RGB').resize((w, h)), np.uint8)
            rgb = bg.copy()
        else:
            rgb = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        mask = np.zeros((h, w), np.uint8)
        begins = np.zeros((n_cls, 2), np.int32)
        poses = [np.zeros((3, 4), np.float32)] * n_cls
        for cls in FUSE_CLS_ORDER:
            if cls not in class_renders:
                continue
            idx = FUSE_CLS_ORDER.index(cls)
            rdir = os.path.join(root, class_renders[cls])
            j = int(rng.integers(counts[cls]))
            img = np.asarray(Image.open(
                os.path.join(rdir, f'{j}.jpg')).convert('RGB'), np.uint8)
            depth = _read_img(os.path.join(rdir, f'{j}_depth.png'))
            if depth.ndim == 3:
                depth = depth.sum(2)
            with open(os.path.join(rdir, f'{j}_RT.pkl'), 'rb') as f:
                RT = np.asarray(pickle.load(f)['RT'], np.float32)
            dy, dx = rng.integers(-max_shift, max_shift + 1, 2)
            src = depth > 0
            ys, xs = np.nonzero(src)
            ty, tx = ys + dy, xs + dx
            ok = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
            rgb[ty[ok], tx[ok]] = img[ys[ok], xs[ok]]
            mask[ty[ok], tx[ok]] = idx + 1
            begins[idx] = (dy, dx)
            poses[idx] = RT
        Image.fromarray(rgb).save(os.path.join(base, f'{k}_rgb.jpg'))
        Image.fromarray(mask).save(os.path.join(base, f'{k}_mask.png'))
        _save_pkl((begins, poses), os.path.join(base, f'{k}_info.pkl'))
    return n_images
