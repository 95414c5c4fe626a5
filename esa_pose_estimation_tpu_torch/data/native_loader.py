"""ctypes binding of the native shard loader (``native/src/shard_loader.cpp``)
that hands out batches as page-locked CPU tensors (torch port of the JAX
package's ``data/native_loader.py``).

:func:`build_library` compiles the C++ source of the checkout with ``g++``
at first use into the port's own build directory, ``build/torch_native/``
at the root of the checkout, under a name that hashes the source and the
command.  It writes a temporary file and renames it, so two processes
building at once never load a half-written library.

The source decodes PNG payloads with libpng.  It compiles against the
libpng 1.6 headers kept in ``third_party/libpng/`` (unmodified copies;
their license is in ``png.h``), since a machine may have the library
without its headers, and links the system's ``libpng16`` where the
dynamic linker knows one, else the ``libpng16`` that Pillow's wheel
bundles (a machine may have only that one).
:class:`NativeBatchLoader` streams batches from an SPD1 shard
(``data/shards.py``) on C++ worker threads, which keep decoded batches
ready ahead of the training step.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from esa_pose_estimation_tpu_torch.data.shards import NAME_LEN, read_meta

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / 'native' / 'src' / 'shard_loader.cpp'
PNG_INCLUDE = _PKG / 'third_party' / 'libpng'
BUILD_DIR = _PKG.parent / 'build' / 'torch_native'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def libpng_args() -> list[str]:
    """The linker arguments for libpng 1.6: the system's, else Pillow's
    bundled copy (by path, with its directory as the run path); raises if
    there is neither."""
    if ctypes.util.find_library('png16'):
        return ['-l:libpng16.so.16']
    import PIL
    libs = Path(PIL.__file__).resolve().parents[1] / 'pillow.libs'
    found = sorted(libs.glob('libpng16*.so*'))
    if not found:
        raise RuntimeError('native loader: no libpng16 on this machine '
                           '(neither the system\'s nor Pillow\'s)')
    return [str(found[-1]), f'-Wl,-rpath,{libs}']


def build_command(out: Path) -> list[str]:
    """The ``g++`` command that builds :data:`SOURCE`, and nothing else,
    into ``out``."""
    return ['g++', *GXX_FLAGS, f'-I{PNG_INCLUDE}', str(SOURCE), '-o',
            str(out), *libpng_args(), '-lz', '-lpthread']


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join(
        build_command(Path('-'))).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libshardloader_{digest}.so'


def build_library() -> Path:
    """Compile the loader unless a library built from the same source and
    command exists; returns its path.  A failed build raises with the
    compiler's output."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = build_command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'native loader build failed (rc '
                           f'{proc.returncode}):\n$ {" ".join(cmd)}\n'
                           f'{proc.stderr}')
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            ptr, u64 = ctypes.c_void_p, ctypes.c_uint64
            lib.loader_open3.restype = ptr
            lib.loader_open3.argtypes = ([ctypes.c_char_p]
                                         + [ctypes.c_int] * 3
                                         + [u64, ctypes.c_int, ctypes.c_int,
                                            u64, u64])
            lib.loader_next.restype = ctypes.c_int
            lib.loader_next.argtypes = [ptr] * 7
            lib.loader_next_cropped.restype = ctypes.c_int
            lib.loader_next_cropped.argtypes = [ptr] * 9
            lib.loader_reset.argtypes = [ptr, u64]
            lib.loader_close.argtypes = [ptr]
            _lib = lib
    return _lib


class NativeBatchLoader:
    """Iterate batches of an SPD1 shard through the C++ loader.

    Yields dicts {'frame' (B, H, W) uint8, 'bbox' (B, 4), 'keypoints_2d'
    (B, K, 2), 'quat' (B, 4), 'trans' (B, 3), 'name' [str] * B} of CPU
    tensors, as ``data/speed.BatchLoader`` yields numpy arrays.  Frames
    stay uint8 on the host, so the copy to the card moves one byte per
    pixel; the crop casts them to f32 there.  For a CUDA ``device`` (the
    default; without a card it raises) the tensors are page-locked, so
    their copies to the card do not block the host.

    With ``crop_size`` the C++ workers run the box -> square crop ->
    bilinear resize stage on the host (the reference's CPU DataLoader runs
    the same stage, data_load4.py:110-166) and batches hold {'crop'
    (B, S, S) f32, 'rate' (B,), 'origin' (B, 2)} in place of 'frame':
    about 36x fewer bytes to the card per 1920x1200 frame.

    Process ``process_id`` of ``process_count`` streams the contiguous
    record slice ``[n*i//P, n*(i+1)//P)`` of the shard (that of
    ``parallel/distributed.local_slice``), with no coordination.  An epoch
    is one pass (``iter``); the second and later passes reshuffle with
    ``seed + epoch``.  A truncated or corrupt shard raises.
    """

    def __init__(self, shard_path: str, batch_size: int,
                 n_threads: int = 4, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, crop_size: int | None = None,
                 process_id: int = 0, process_count: int = 1,
                 device=None):
        from esa_pose_estimation_tpu_torch.utils.artifact import (
            target_device,
        )
        self.pin = target_device(device, 'NativeBatchLoader').type == 'cuda'
        self.meta = read_meta(shard_path)
        self.path = shard_path
        self.batch_size = batch_size
        self.crop_size = int(crop_size) if crop_size else 0
        if not 0 <= process_id < process_count:
            raise ValueError(f'process_id {process_id} outside '
                             f'process_count {process_count}')
        n = self.meta.n_records
        start = n * process_id // process_count
        self.n_local = n * (process_id + 1) // process_count - start
        if self.n_local == 0:
            raise ValueError(f'{shard_path}: {n} records leave none for '
                             f'process {process_id} of {process_count}')
        self._handle = _load().loader_open3(
            shard_path.encode(), batch_size, n_threads, int(shuffle),
            seed, int(drop_last), self.crop_size, start, self.n_local)
        if not self._handle:
            raise OSError(f'failed to open shard {shard_path}')
        self._epoch = 0
        self._seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = self.n_local // self.batch_size
        if not self.drop_last and self.n_local % self.batch_size:
            n += 1
        return n

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin)

    def __iter__(self):
        lib = _load()
        if self._epoch > 0:
            lib.loader_reset(self._handle, self._seed + self._epoch)
        self._epoch += 1
        m, b, cs = self.meta, self.batch_size, self.crop_size
        f32 = torch.float32
        while True:
            out = {'bbox': self._empty((b, 4), f32),
                   'keypoints_2d': self._empty((b, m.n_kp, 2), f32),
                   'quat': self._empty((b, 4), f32),
                   'trans': self._empty((b, 3), f32)}
            names = ctypes.create_string_buffer(b * NAME_LEN)
            tail = [out[k].data_ptr() for k in ('bbox', 'keypoints_2d',
                                                  'quat', 'trans')] + [
                ctypes.addressof(names)]
            if cs:
                out['crop'] = self._empty((b, cs, cs), f32)
                out['rate'] = self._empty((b,), f32)
                out['origin'] = self._empty((b, 2), f32)
                count = lib.loader_next_cropped(
                    self._handle, out['crop'].data_ptr(),
                    out['rate'].data_ptr(), out['origin'].data_ptr(), *tail)
            else:
                out['frame'] = self._empty((b, m.height, m.width),
                                           torch.uint8)
                count = lib.loader_next(self._handle,
                                        out['frame'].data_ptr(), *tail)
            if count < 0:
                raise RuntimeError(
                    f'native loader I/O or decode error reading '
                    f'{self.path!r} (corrupt or truncated shard?)')
            if count == 0:
                return
            out = {k: v[:count] for k, v in out.items()}
            out['name'] = [
                names.raw[i * NAME_LEN:(i + 1) * NAME_LEN].split(b'\0')[0]
                .decode() for i in range(count)]
            yield out

    def close(self) -> None:
        if self._handle:
            _load().loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, '_handle', None) and _lib is not None:
            _lib.loader_close(self._handle)
            self._handle = None
