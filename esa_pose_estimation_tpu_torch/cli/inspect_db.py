"""Inspect a pickle image-DB: schema, stats, and integrity checks (port
of the JAX package's ``cli/inspect_db.py``; numpy and pickle only).

The reference's scratch scripts (data_prepare.py — load three pkls and
print; leastsq_test.py / test.py — ad-hoc fit demos) exist to answer one
question during dataset work: "what is actually inside this pkl, and is
it consistent?".  This CLI answers it properly for both DB families:

* SPEED/ESA splits (data_load4.py:90-101 dicts: ``rgb_pth``, ``bbox``,
  ``sift``, ``sift3d``, ``K``, ``RT``, ``qua``)
* LINEMOD real/render/fuse/occlusion DBs (data_load3.py records:
  ``rgb_pth``, ``dpt_pth``, ``msk``/mask paths, ``RT``, per-class fields)

Usage:
  python -m esa_pose_estimation_tpu_torch.cli.inspect_db data/train.pkl \
      [--image-root /data/speed/images/train] [--check-images] \
      [--sample 3]

Prints one summary block per pkl: record count, the union key schema
with types/shapes, bbox geometry stats, pose/translation ranges, and —
with ``--check-images`` — how many referenced image files exist on disk.
"""

from __future__ import annotations

import argparse
import collections
import os
import pickle

import numpy as np


def _describe_value(v) -> str:
    if isinstance(v, np.ndarray):
        return f'ndarray{tuple(v.shape)}:{v.dtype}'
    if isinstance(v, (bytes, str)):
        s = v.decode() if isinstance(v, bytes) else v
        return f'{type(v).__name__}(e.g. {s[:40]!r})'
    if isinstance(v, (list, tuple)):
        return f'{type(v).__name__}[{len(v)}]'
    return type(v).__name__


def _as_records(obj) -> list:
    """pkl payloads are either a list of record dicts (ESA/LINEMOD) or a
    dict of named sub-DBs (some builders); normalize to a flat list."""
    if isinstance(obj, dict):
        # dict-of-lists (e.g. {'train': [...], 'test': [...]}) flattens;
        # a single record dict wraps
        if obj and all(isinstance(v, (list, tuple)) for v in obj.values()):
            out = []
            for v in obj.values():
                out.extend(v)
            return out
        return [obj]
    return list(obj)


def summarize(path: str, image_root: str = '', check_images: bool = False,
              sample: int = 0) -> dict:
    with open(path, 'rb') as f:
        payload = pickle.load(f, encoding='bytes')
    records = _as_records(payload)
    n = len(records)
    print(f'== {path}: {n} records '
          f'({type(payload).__name__} payload)')
    stats: dict = {'path': path, 'records': n}
    if n == 0:
        return stats

    # union schema with presence counts
    keys: collections.Counter = collections.Counter()
    example: dict = {}
    for r in records:
        if not isinstance(r, dict):
            continue
        for k, v in r.items():
            kk = k.decode() if isinstance(k, bytes) else str(k)
            keys[kk] += 1
            example.setdefault(kk, v)
    print('   schema (key: presence, type):')
    for k in sorted(keys):
        print(f'     {k}: {keys[k]}/{n}  {_describe_value(example[k])}')
    stats['schema'] = {k: keys[k] for k in keys}

    def _field(name):
        out = []
        for r in records:
            if isinstance(r, dict):
                v = r.get(name, r.get(name.encode()))
                if v is not None:
                    out.append(np.asarray(v, np.float64))
        return out

    boxes = _field('bbox')
    if boxes and boxes[0].size == 4:
        b = np.stack([x.reshape(4) for x in boxes])
        w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
        print(f'   bbox: w {w.min():.0f}..{w.max():.0f} '
              f'(median {np.median(w):.0f}), '
              f'h {h.min():.0f}..{h.max():.0f} '
              f'(median {np.median(h):.0f}), '
              f'{int((w <= 0).sum() + (h <= 0).sum())} degenerate')
        stats['bbox_median_wh'] = [float(np.median(w)), float(np.median(h))]

    rts = _field('RT')
    if rts and rts[0].shape[-2:] == (3, 4):
        t = np.stack([x.reshape(3, 4)[:, 3] for x in rts])
        depth = t[:, 2]
        print(f'   RT: {len(rts)} poses, depth z {depth.min():.2f}..'
              f'{depth.max():.2f} (median {np.median(depth):.2f})')
        stats['depth_range'] = [float(depth.min()), float(depth.max())]

    sift = _field('sift')
    if sift:
        k = sift[0].reshape(-1, 2).shape[0]
        print(f'   sift: {len(sift)} records x {k} 2D keypoints')
        stats['keypoints'] = k

    if check_images:
        missing = 0
        for r in records:
            if not isinstance(r, dict):
                continue
            p = r.get('rgb_pth', r.get(b'rgb_pth'))
            if p is None:
                continue
            p = p.decode() if isinstance(p, bytes) else str(p)
            if not os.path.exists(os.path.join(image_root, p)):
                missing += 1
        print(f'   images: {n - missing}/{n} present under '
              f'{image_root or "."!s}')
        stats['missing_images'] = missing

    for i in range(min(sample, n)):
        r = records[i]
        if isinstance(r, dict):
            p = r.get('rgb_pth', r.get(b'rgb_pth'))
            print(f'   sample[{i}]: rgb_pth={p!r}')
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('pkls', nargs='+', help='pickle DB file(s)')
    ap.add_argument('--image-root', default='',
                    help='prefix for rgb_pth when checking image files')
    ap.add_argument('--check-images', action='store_true',
                    help='verify each referenced image exists on disk')
    ap.add_argument('--sample', type=int, default=0,
                    help='print the first N record names')
    args = ap.parse_args(argv)
    return [summarize(p, args.image_root, args.check_images, args.sample)
            for p in args.pkls]


if __name__ == '__main__':
    main()
