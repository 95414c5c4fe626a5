"""SPEED dataset ingestion (ESA/Kelvins 2019).

The port's own copy of the JAX package's ``data/speed.py`` (stdlib, numpy
and, for image files, Pillow), plus :func:`to_device`, the commands' step
from host batch to card.

Host-side IO for the real dataset, device-side everything else.  Covers the
reference's three ingestion paths:

* competition JSON splits (reference: utils.py:42-65
  ``process_json_dataset`` — train.json / test.json / real_test.json with
  ``q_vbs2tango`` / ``r_Vo2To_vbs_true`` labels);
* the precomputed pickle records consumed by the dataloaders
  (reference: data_load4.py:90-101 — dicts with ``rgb_pth``, ``bbox``,
  ``sift`` 2D keypoints, ``sift3d`` model points, ``K``, ``RT``, ``qua``);
* grayscale PNG frames (reference: data_load4.py:47-51 ``read_mask_np``).

Design split vs the reference: the reference's DataLoader workers do crop /
heatmap-render / normalize on CPU per sample (SURVEY §3.4); here the host
only decodes PNGs and ships raw frames + boxes — cropping, target rendering
and augmentation are the batched device ops in ops/crop.py, ops/heatmap.py
and data/augment.py.  ``BatchLoader`` overlaps host decode of batch i+1
with device compute of batch i via a background thread; its batches are
host numpy, and the commands move them with :func:`to_device`.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch


@dataclass
class SpeedSplits:
    partitions: dict[str, list[str]]
    labels: dict[str, dict[str, list[float]]]


def process_json_dataset(root_dir: str) -> SpeedSplits:
    """Parse the competition JSON metadata (utils.py:42-65 parity)."""
    with open(os.path.join(root_dir, 'train.json')) as f:
        train = json.load(f)
    with open(os.path.join(root_dir, 'test.json')) as f:
        test = json.load(f)
    with open(os.path.join(root_dir, 'real_test.json')) as f:
        real_test = json.load(f)

    partitions = {'train': [], 'test': [], 'real_test': []}
    labels: dict[str, dict[str, list[float]]] = {}
    for ann in train:
        partitions['train'].append(ann['filename'])
        labels[ann['filename']] = {'q': ann['q_vbs2tango'],
                                   'r': ann['r_Vo2To_vbs_true']}
    for ann in test:
        partitions['test'].append(ann['filename'])
    for ann in real_test:
        partitions['real_test'].append(ann['filename'])
    return SpeedSplits(partitions=partitions, labels=labels)


def load_pickle_records(path: str) -> list[dict[str, Any]]:
    """Load the precomputed per-image records (data/train.pkl etc.,
    data_load4.py:90-101 layout).

    ``encoding='latin1'`` decodes Python-2-era pickles with str keys and
    numpy arrays intact ('bytes' would turn every dict key into bytes and
    break the str lookups downstream)."""
    with open(path, 'rb') as f:
        return pickle.load(f, encoding='latin1')


def save_pickle_records(path: str, records: list[dict[str, Any]]) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(records, f)


def read_gray_image(path: str) -> np.ndarray:
    """Grayscale uint8 frame (read_mask_np parity, data_load4.py:47-51).

    ``convert('L')`` is a no-op for SPEED's 8-bit grayscale frames and
    makes RGB or 16-bit inputs well-defined instead of a shape error /
    silent wraparound in batch assembly."""
    from PIL import Image
    return np.asarray(Image.open(path).convert('L'), dtype=np.uint8)


@dataclass
class Record:
    """One training/eval example in host memory."""
    image_path: str
    bbox: np.ndarray               # (4,) [x1, y1, x2, y2]
    keypoints_2d: np.ndarray | None  # (K, 2) full-frame ('sift')
    keypoints_3d: np.ndarray       # (K, 3) model points ('sift3d')
    K: np.ndarray                  # (3, 3)
    quat: np.ndarray | None        # (4,) (w, x, y, z)
    trans: np.ndarray | None       # (3,)
    name: str = ''


# SPEED synthetic frames are named imgNNNNNN.jpg (13 chars); real-capture
# frames have longer names.  The reference's mixed train+real_test loader
# routes each record to its directory by this filename length
# (data_load5.py:110-113).
SYNTHETIC_NAME_LEN = 13


def mixed_image_path(image_root: str, rgb_pth: str,
                     train_dir: str = 'train',
                     real_dir: str = 'real_test') -> str:
    """data_load5.py:110-113 path rule: 13-char record paths live under
    ``train/``, everything else under ``real_test/``.

    The reference tests ``len(des['rgb_pth'])`` on the FULL string, not
    the basename — a record whose ``rgb_pth`` carried a directory prefix
    would route to ``real_test/`` regardless of its filename, and we
    reproduce exactly that."""
    sub = (train_dir if len(rgb_pth) == SYNTHETIC_NAME_LEN else real_dir)
    return os.path.join(image_root, sub, rgb_pth)


def records_from_pickle_mixed(path: str, image_root: str = '') -> list[Record]:
    """The data_load5 train split: one pickle mixing synthetic-train and
    real_test records, images resolved per-record by filename length.
    Pair with ``norm_mean=0.5`` (data_load5.py:80-88 Normalize(mean=[0.5]))
    in ``build_batch``/``infer_poses``."""
    out = records_from_pickle(path)
    for r in out:
        r.image_path = mixed_image_path(image_root, r.image_path)
    return out


def records_from_pickle(path: str, image_root: str = '') -> list[Record]:
    out = []
    for des in load_pickle_records(path):
        rt = des.get('RT')
        out.append(Record(
            image_path=os.path.join(image_root, des['rgb_pth']),
            bbox=np.asarray(des['bbox'], np.float32),
            keypoints_2d=(np.asarray(des['sift'], np.float32).reshape(-1, 2)
                          if 'sift' in des else None),
            keypoints_3d=np.asarray(des['sift3d'], np.float32).reshape(-1, 3),
            K=np.asarray(des['K'], np.float32),
            quat=(np.asarray(des['qua'], np.float32)
                  if des.get('qua') is not None else None),
            trans=(np.asarray(rt, np.float32)[:, 3]
                   if rt is not None else None),
            name=os.path.basename(des['rgb_pth']),
        ))
    return out


class BatchLoader:
    """Background-threaded host loader: PNG decode + stacking off the main
    thread, raw frames shipped to device.  The role DataLoader(num_workers=4)
    plays in the reference (main.py:273), without per-sample CPU transforms.
    """

    def __init__(self, records: list[Record], batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, frame_hw: tuple[int, int] = (1200, 1920)):
        self.records = records
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

    def _assemble(self, batch: list[Record]) -> dict[str, np.ndarray]:
        h, w = self.frame_hw
        n = len(batch)
        # uint8 on the host: 4x less RAM and H2D traffic than f32 for
        # data the device pipeline casts anyway (ops/crop.py:190); same
        # policy as the native loader.
        frames = np.zeros((n, h, w), np.uint8)
        for i, r in enumerate(batch):
            img = read_gray_image(r.image_path)
            frames[i, :img.shape[0], :img.shape[1]] = img[:h, :w]
        out = {
            'frame': frames,
            'bbox': np.stack([r.bbox for r in batch]),
            'keypoints_3d': np.stack([r.keypoints_3d for r in batch]),
            'K': np.stack([r.K for r in batch]),
            'name': [r.name for r in batch],
        }
        # Key presence must hold for the WHOLE batch (a shuffled mix of
        # labeled and unlabeled records would otherwise stack None).
        if all(r.keypoints_2d is not None for r in batch):
            out['keypoints_2d'] = np.stack([r.keypoints_2d for r in batch])
        if all(r.quat is not None and r.trans is not None for r in batch):
            out['quat'] = np.stack([r.quat for r in batch])
            out['trans'] = np.stack([r.trans for r in batch])
        return out

    def __iter__(self) -> Iterator[dict[str, Any]]:
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
            # Failures must reach the consumer (a dead producer that
            # never enqueues the sentinel hangs the train loop forever),
            # and an abandoned consumer must release the producer (a
            # blocking q.put would strand prefetched full-res batches
            # for the life of the process).
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


def to_device(a: np.ndarray | torch.Tensor, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a CUDA device it is
    copied from page-locked memory, without blocking the host; on the CPU
    it shares the array's memory.  A tensor is moved (or kept) as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t
