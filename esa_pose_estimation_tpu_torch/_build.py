"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface under ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the source, and is loaded with ``ctypes``.  All sources
compile in parallel on first use; a library already built from the same
source is reused.  Nothing else is fetched or read: ``python3
chip_smoke.py`` builds them from the checkout alone.  A missing ``nvcc`` or
a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME or put nvcc on PATH)')


def _lib_path(src: Path) -> Path:
    # the headers beside the sources are part of every library's hash
    headers = b''.join(h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{src.stem}_{digest}.so'


def build_all() -> float:
    """Compile every ``csrc/*.cu`` not yet built, all at once; load all.
    Returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        sources = sorted(CSRC.glob('*.cu'))
        todo = [s for s in sources if not _lib_path(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src in todo:
                tmp = _lib_path(src).with_suffix(f'.{os.getpid()}.tmp')
                cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            failures = []
            for src, tmp, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f'{src.name}:\n{out.decode(errors="replace")}')
                else:
                    os.replace(tmp, _lib_path(src))
            if failures:
                raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
        for src in sources:
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def check(err: int, what: str, errors: dict[int, str] | None = None
          ) -> None:
    """Raise if a C entry point returned non-zero: a ``cudaError_t``, or
    one of the entry point's own (negative) codes, named in ``errors``."""
    if errors and err in errors:
        raise RuntimeError(f'{what}: {errors[err]}')
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {err}')
