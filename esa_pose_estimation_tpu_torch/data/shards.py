"""The packed shard format "SPD1" and its writer, read by the native loader
(torch port of the JAX package's ``data/shards.py``; the byte layout is the
same, so either package reads the other's shards).

One shard file holds a whole split: a fixed header, then per record a
fixed-size header (name, bbox, quat, trans, payload size) and a payload of
``[kp2d f32 x n_kp*2][frame pixels]``, the frame either raw uint8 (h*w) or
a PNG byte stream.  The sequential layout with fixed record framing is
what lets the C++ loader (``native/src/shard_loader.cpp``) stream and
decode batches with plain reads on worker threads, in place of per-image
PNG reads in DataLoader processes (reference: main.py:273).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np
import torch

MAGIC = 0x31445053  # "SPD1"
NAME_LEN = 64
_HEADER = struct.Struct('<IIIIIB')
_REC_FIXED = struct.Struct(f'<{NAME_LEN}s4f4f3fI')


@dataclass
class ShardMeta:
    n_records: int
    height: int
    width: int
    n_kp: int
    compressed: bool


class ShardWriter:
    """Write a split into one shard file."""

    def __init__(self, path: str, height: int, width: int, n_kp: int,
                 compressed: bool = False):
        self.path = path
        self.height = height
        self.width = width
        self.n_kp = n_kp
        self.compressed = compressed
        self._file = open(path, 'wb')
        self._count = 0
        # placeholder header, rewritten on close
        self._file.write(_HEADER.pack(MAGIC, 0, height, width, n_kp,
                                      int(compressed)))

    def add(self, name: str, frame: np.ndarray, bbox, keypoints_2d,
            quat=None, trans=None) -> None:
        """frame: (h, w) uint8, at most the shard's height and width (the
        reader zero-pads smaller frames)."""
        kp = np.zeros((self.n_kp, 2), np.float32)
        kp2d = np.asarray(keypoints_2d, np.float32).reshape(-1, 2)
        kp[:len(kp2d)] = kp2d[:self.n_kp]
        if self.compressed:
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(np.asarray(frame, np.uint8)).save(buf, 'PNG')
            pixels = buf.getvalue()
        else:
            padded = np.zeros((self.height, self.width), np.uint8)
            f = np.asarray(frame, np.uint8)
            padded[:f.shape[0], :f.shape[1]] = f
            pixels = padded.tobytes()
        payload = kp.tobytes() + pixels
        q = np.asarray(quat if quat is not None else [1, 0, 0, 0], np.float32)
        t = np.asarray(trans if trans is not None else [0, 0, 0], np.float32)
        b = np.asarray(bbox, np.float32)
        self._file.write(_REC_FIXED.pack(
            name.encode()[:NAME_LEN].ljust(NAME_LEN, b'\0'),
            *b.tolist(), *q.tolist(), *t.tolist(), len(payload)))
        self._file.write(payload)
        self._count += 1

    def close(self) -> None:
        self._file.seek(0)
        self._file.write(_HEADER.pack(MAGIC, self._count, self.height,
                                      self.width, self.n_kp,
                                      int(self.compressed)))
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_meta(path: str) -> ShardMeta:
    """The shard's header; a file that is not an SPD1 shard raises."""
    with open(path, 'rb') as f:
        head = f.read(_HEADER.size)
    if len(head) < _HEADER.size:
        raise ValueError(f'not an SPD1 shard (short header): {path}')
    magic, n, h, w, k, c = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ValueError(f'not an SPD1 shard: {path}')
    return ShardMeta(n_records=n, height=h, width=w, n_kp=k,
                     compressed=bool(c))


def write_synthetic_shard(path: str, n_records: int,
                          height: int = 1200, width: int = 1920,
                          n_kp: int = 30, compressed: bool = False,
                          batch: int = 16, seed: int = 0,
                          device=None) -> int:
    """Render synthetic SPEED-like frames (``data/synthetic.make_sample``)
    and pack them into one shard; returns the records written.

    A full-frame corpus for the native loader without the real dataset, so
    ``cli/train --train-shard`` runs self-contained.  ``compressed=False``
    writes raw uint8 frames (the fast layout); ``True`` writes PNG streams
    (the reference's format on disk, bound by the decode).  Frames render
    on ``device`` (``cuda`` unless asked otherwise) and are cast to uint8
    there, so a quarter of the bytes come back to the host.
    """
    from esa_pose_estimation_tpu_torch.data import synthetic
    from esa_pose_estimation_tpu_torch.utils.artifact import target_device
    from esa_pose_estimation_tpu_torch.utils.seeding import generator

    dev = target_device(device, 'write_synthetic_shard')
    pts = synthetic.spacecraft_points(device=dev, n=n_kp)
    written = 0
    with ShardWriter(path, height, width, n_kp, compressed=compressed) as w:
        for j in range(-(-n_records // batch)):
            s = synthetic.make_sample(generator(dev, seed, j), pts, batch,
                                      height=height, width=width)
            frames = torch.clamp(s.image, 0, 255).to(torch.uint8).cpu().numpy()
            bbox, kp2d, quat, trans = (t.cpu().numpy() for t in (
                s.bbox, s.keypoints_2d, s.quat, s.trans))
            for i in range(min(batch, n_records - written)):
                w.add(f'synth{written:06d}.png', frames[i], bbox[i],
                      kp2d[i], quat[i], trans[i])
                written += 1
    return written


def write_shard_from_records(path: str, records, image_root: str = '',
                             height: int = 1200, width: int = 1920,
                             compressed: bool = True) -> int:
    """Pack ``data/speed.py`` Records (and their images) into one shard."""
    from esa_pose_estimation_tpu_torch.data.speed import read_gray_image
    n_kp = (len(records[0].keypoints_2d)
            if records[0].keypoints_2d is not None else 0)
    with ShardWriter(path, height, width, max(n_kp, 1),
                     compressed=compressed) as w:
        for r in records:
            frame = read_gray_image(r.image_path)
            w.add(r.name, frame, r.bbox,
                  r.keypoints_2d if r.keypoints_2d is not None
                  else np.zeros((1, 2)),
                  r.quat, r.trans)
    return len(records)
