"""LINEMOD model database, the data2/ pickle records, and their batch
loader (torch port of the JAX package's ``data/linemod.py``; host numpy,
as there).

Replaces the reference's ``LineModModelDB`` (evaluation.py:31-160) and its
plyfile/np dependencies: a minimal PLY parser (ascii + binary-LE), model
diameter computation, farthest-point keypoints (``ops/geometry`` FPS on a
CPU tensor, the role of the native ``farthest_point_sampling`` C++ kernel)
and bb8 corners.  No hardcoded filesystem layout: callers register mesh
paths.  :class:`LinemodBatchLoader` decodes the frames and masks on the
host; the crop and the targets run on the device
(``ops/crop.crop_resize_linemod``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from esa_pose_estimation_tpu_torch.obs.visual import bb8_corners


LINEMOD_CLASSES = ['ape', 'benchvise', 'bowl', 'cam', 'can', 'cat', 'cup',
                   'driller', 'duck', 'eggbox', 'glue', 'holepuncher',
                   'iron', 'lamp', 'phone']
SYMMETRIC_CLASSES = {'eggbox', 'glue', 'bowl', 'cup'}


def load_ply_vertices(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii / binary_little_endian). -> (N, 3)."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'not a PLY file: {path}')
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b'format'):
                fmt = line.split()[1].decode()
            elif line.startswith(b'element'):
                parts = line.split()
                in_vertex = parts[1] == b'vertex'
                if in_vertex:
                    n_vertex = int(parts[2])
            elif line.startswith(b'property') and in_vertex:
                parts = line.split()
                props.append((parts[-1].decode(), parts[1].decode()))
            elif line == b'end_header':
                break

        type_size = {'float': ('f', 4), 'float32': ('f', 4),
                     'double': ('d', 8), 'float64': ('d', 8),
                     'uchar': ('B', 1), 'uint8': ('B', 1),
                     'char': ('b', 1), 'int8': ('b', 1),
                     'short': ('h', 2), 'ushort': ('H', 2),
                     'int': ('i', 4), 'int32': ('i', 4),
                     'uint': ('I', 4), 'uint32': ('I', 4)}
        if fmt == 'ascii':
            rows = []
            name_idx = {name: i for i, (name, _) in enumerate(props)}
            for _ in range(n_vertex):
                vals = f.readline().split()
                rows.append([float(vals[name_idx[c]]) for c in 'xyz'])
            return np.asarray(rows, np.float64)
        if fmt != 'binary_little_endian':
            raise ValueError(f'unsupported PLY format: {fmt}')
        codes = ''.join(type_size[t][0] for _, t in props)
        rec = struct.Struct('<' + codes)
        name_idx = {name: i for i, (name, _) in enumerate(props)}
        data = f.read(rec.size * n_vertex)
        out = np.zeros((n_vertex, 3))
        for i in range(n_vertex):
            vals = rec.unpack_from(data, i * rec.size)
            out[i] = [vals[name_idx['x']], vals[name_idx['y']],
                      vals[name_idx['z']]]
        return out


def model_diameter(vertices: np.ndarray, exact_limit: int = 4096) -> float:
    """Max pairwise distance (evaluation.py diameter semantics).

    Meshes up to ``exact_limit`` vertices are exact (full pairwise).
    Larger meshes use the convex-hull vertices when scipy is available
    (the diameter is attained between hull vertices, so that is exact
    too); without scipy, extremes along 256 fixed random directions give
    a slight lower bound (the true pair need not be extremal along any
    sampled direction) — adequate for the 0.1*diameter ADD threshold,
    and deterministic (seed 0)."""
    v = np.asarray(vertices)
    if len(v) > exact_limit:
        try:
            from scipy.spatial import ConvexHull
            v = v[np.unique(ConvexHull(v).vertices)]
        except Exception:
            rng = np.random.default_rng(0)
            dirs = rng.normal(size=(256, 3))
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            proj = v @ dirs.T
            idx = np.unique(np.concatenate([proj.argmax(0),
                                            proj.argmin(0)]))
            v = v[idx]
        if len(v) > exact_limit:
            # hull still huge: chunk the pairwise max to bound memory
            best = 0.0
            for i in range(0, len(v), exact_limit):
                blk = v[i:i + exact_limit]
                d = np.linalg.norm(blk[:, None] - v[None, :], axis=-1)
                best = max(best, float(d.max()))
            return best
    d = np.linalg.norm(v[:, None] - v[None, :], axis=-1)
    return float(d.max())


@dataclass
class ModelInfo:
    vertices: np.ndarray
    diameter: float
    center: np.ndarray
    corners: np.ndarray                  # (8, 3) bb8
    farthest: dict[int, np.ndarray] = field(default_factory=dict)


class LineModModelDB:
    """Mesh/diameter/keypoint database (evaluation.py:31-160 parity).

    Register mesh paths (or raw vertex arrays) per class, then query
    diameters, bb8 corners and FPS keypoints — all computed on demand and
    cached, instead of read from the reference's pickled side files.
    """

    def __init__(self):
        self._models: dict[str, ModelInfo] = {}

    def register(self, name: str, ply_path: str | None = None,
                 vertices: np.ndarray | None = None) -> None:
        if vertices is None:
            assert ply_path is not None and os.path.exists(ply_path), ply_path
            vertices = load_ply_vertices(ply_path)
        vertices = np.asarray(vertices, np.float64)
        self._models[name] = ModelInfo(
            vertices=vertices,
            diameter=model_diameter(vertices),
            center=vertices.mean(axis=0),
            corners=bb8_corners(vertices),
        )

    def get_diameter(self, name: str) -> float:
        return self._models[name].diameter

    def get_ply_model(self, name: str) -> np.ndarray:
        return self._models[name].vertices

    def get_corners_3d(self, name: str) -> np.ndarray:
        return self._models[name].corners

    def get_centers_3d(self, name: str) -> np.ndarray:
        return self._models[name].center

    def get_farthest_3d(self, name: str, num: int = 8) -> np.ndarray:
        """FPS keypoints on the mesh (the canonical PVNet keypoints,
        extend_utils.py:23-38 role)."""
        info = self._models[name]
        if num not in info.farthest:
            import torch

            from esa_pose_estimation_tpu_torch.ops.geometry import (
                farthest_point_sampling,
            )
            v = info.vertices
            if len(v) > 8192:     # FPS cost control on big meshes
                step = len(v) // 8192 + 1
                v = v[::step]
            idx = farthest_point_sampling(
                torch.as_tensor(v, dtype=torch.float32), num + 1).numpy()
            # skip the centroid-seeded first point (reference keypoints are
            # the farthest set, not including the center)
            info.farthest[num] = v[idx[1:]]
        return info.farthest[num]

    def is_symmetric(self, name: str) -> bool:
        return name in SYMMETRIC_CLASSES


# ---------------------------------------------------------------------------
# Real-data record plumbing (the data2/ pickle layout)
# ---------------------------------------------------------------------------
# The reference trains LINEMOD from per-class pickles mixing three record
# sources (data_load3.py:89-121): the real-train subset of {name}_real.pkl
# (indices recovered from the {name}_train.pkl path list), the first 10000
# {name}_render.pkl synthetic renders, and the {name}_fuse.pkl multi-object
# composites.  Test is the real subset selected by {name}_test.pkl.  Each
# record dict carries rgb_pth / dpt_pth / bbox / sift / sift_3d / K / RT
# (data_load3.py:258-259).

# Mask-index class order used by the fuse composites (data_load3.py:69-70;
# a fuse mask stores index+1 of this list, NOT the alphabetical order).
FUSE_CLS_ORDER = ['ape', 'cam', 'cat', 'duck', 'glue', 'iron', 'phone',
                  'benchvise', 'can', 'driller', 'eggbox', 'holepuncher',
                  'lamp']


def _load_pkl(path: str):
    import pickle
    # latin1 decodes Python-2-era pickles with str keys and numpy arrays
    # intact; 'bytes' would break every str-key lookup on legacy records.
    with open(path, 'rb') as f:
        return pickle.load(f, encoding='latin1')


def split_index(entry) -> int:
    """A {name}_train/test.pkl entry is a tuple whose first element is an
    image path; the record index is its numeric stem
    (data_load3.py:104-112)."""
    path = entry[0] if isinstance(entry, (tuple, list)) else entry
    return int(os.path.basename(str(path)).split('.')[0])


def load_real_split(pkl_dir: str, name: str, split: str) -> list[dict]:
    """Real records of one class filtered to the train or test split."""
    real = _load_pkl(os.path.join(pkl_dir, f'{name}_real.pkl'))
    sel = _load_pkl(os.path.join(pkl_dir, f'{name}_{split}.pkl'))
    return [real[split_index(e)] for e in sel]


def load_mixed_train_records(pkl_dir: str, name: str, use_fuse: bool = True,
                             use_render: bool = True,
                             render_cap: int = 10000) -> list[dict]:
    """The data_load3 train mixture: real-train [+ render[:cap]] [+ fuse],
    in the reference's concatenation order (data_load3.py:115-121)."""
    data = list(load_real_split(pkl_dir, name, 'train'))
    if use_render:
        data += _load_pkl(os.path.join(pkl_dir,
                                       f'{name}_render.pkl'))[:render_cap]
    if use_fuse:
        data += _load_pkl(os.path.join(pkl_dir, f'{name}_fuse.pkl'))
    return data


def load_occlusion_records(pkl_dir: str, name: str) -> list[dict]:
    """OCCLUSION_LINEMOD eval records (data_load3.py:286-289:
    ``occ/{name}_real.pkl``, consumed by result_show.py:95-98)."""
    return list(_load_pkl(os.path.join(pkl_dir, 'occ', f'{name}_real.pkl')))


def decode_class_mask(mask: np.ndarray, rgb_pth: str, cls_name: str,
                      rnd_typ: str | None = None) -> np.ndarray:
    """Binary object mask from a stored mask image (data_load3.py:146-154):
    fuse composites store per-class indices into FUSE_CLS_ORDER;
    real/render masks are any-channel-nonzero.

    Fuse detection prefers the record's explicit ``rnd_typ`` field (the
    PVNet convention our db_builder writes); without one it falls back to
    the reference's rule — first character of the RELATIVE path is 'f'
    (``des['rgb_pth'][0] == 'f'``, i.e. files under ``fuse/``; NOT the
    basename, which for fuse composites is ``{k}_rgb.jpg``)."""
    if rnd_typ is not None:
        is_fuse = (rnd_typ == 'fuse')
    else:
        is_fuse = str(rgb_pth).startswith('f')
    if is_fuse:
        return np.asarray(mask == FUSE_CLS_ORDER.index(cls_name) + 1,
                          np.uint8)
    if mask.ndim == 3:
        return np.asarray(mask.sum(2) > 0, np.uint8)
    return np.asarray(mask > 0, np.uint8)


class LinemodBatchLoader:
    """Host loader for the real LINEMOD layout: RGB + mask PNG decode and
    fixed-shape stacking in a background thread (the DataLoader(num_workers)
    role, main2.py); crop/resize/targets happen on the device via
    ops.crop.crop_resize_linemod.
    """

    def __init__(self, records: list[dict], image_root: str,
                 cls_name: str, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 frame_hw: tuple[int, int] = (480, 640)):
        self.records = records
        self.image_root = image_root
        self.cls_name = cls_name
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.frame_hw = frame_hw
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.records) // self.batch_size
        if not self.drop_last and len(self.records) % self.batch_size:
            n += 1
        return n

    def _assemble(self, batch: list[dict]) -> dict[str, np.ndarray]:
        from PIL import Image
        h, w = self.frame_hw
        n = len(batch)
        frames = np.zeros((n, h, w, 3), np.float32)
        masks = np.zeros((n, h, w), np.float32)
        for i, des in enumerate(batch):
            img = np.asarray(Image.open(
                os.path.join(self.image_root, str(des['rgb_pth']))
            ).convert('RGB'), np.uint8)
            m = np.asarray(Image.open(
                os.path.join(self.image_root, str(des['dpt_pth']))))
            m = decode_class_mask(m, des['rgb_pth'], self.cls_name,
                                  rnd_typ=des.get('rnd_typ'))
            # images larger than frame_hw are cropped, not a shape error
            frames[i, :img.shape[0], :img.shape[1]] = img[:h, :w]
            masks[i, :m.shape[0], :m.shape[1]] = m[:h, :w]
        out = {
            'frame': frames,
            'mask': masks,
            'bbox': np.stack([np.asarray(d['bbox'], np.float32)
                              for d in batch]),
            'keypoints_2d': np.stack(
                [np.asarray(d['sift'], np.float32).reshape(-1, 2)
                 for d in batch]),
            'K': np.stack([np.asarray(d['K'], np.float32) for d in batch]),
        }
        if all(d.get('RT') is not None for d in batch):
            rt = np.stack([np.asarray(d['RT'], np.float32) for d in batch])
            out['R'] = rt[:, :, :3]
            out['t'] = rt[:, :, 3]
        if all('sift_3d' in d for d in batch):
            out['keypoints_3d'] = np.stack(
                [np.asarray(d['sift_3d'], np.float32).reshape(-1, 3)
                 for d in batch])
        return out

    def __iter__(self):
        import queue
        import threading
        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # Any failure must reach the consumer: a dead producer that
            # never enqueues its sentinel would hang the train loop on
            # q.get() forever (silent job hang on a remote host).  An
            # abandoned consumer (early break) must release the producer.
            try:
                for idxs in batches:
                    if not _put(self._assemble(
                            [self.records[i] for i in idxs])):
                        return
                _put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
