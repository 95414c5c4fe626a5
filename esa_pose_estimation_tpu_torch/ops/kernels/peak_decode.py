"""Peak decode on Hopper: first-occurrence argmax + log-Taylor refine.

Replaces the TPU kernel ``esa_pose_estimation_tpu/ops/pallas/peak_decode.py``
``decode_heatmaps_pallas`` (body ``_kernel``).  The CUDA source is
``csrc/peak_decode.cu``; the plain PyTorch version is
``ops/peak.decode_heatmaps``.

Bound on the card: bytes.  The function reads every heatmap value once
(B*S*S*K*4 bytes: 503 MB at B=256, S=128, K=30, about 0.15 ms at
3.35 TB/s) and does a handful of operations per value.  The kernel reads
the network's contiguous channels-last (B, S, S, K) output in bands of
rows, one cluster of CTAs per image, with 16-byte loads: each thread keeps
(max, first index) for the fixed keypoints its vector lanes fall on, the
CTA folds them per keypoint, and the cluster folds its bands in rank order
through distributed shared memory before one thread per keypoint evaluates
the 10-tap stencil and the gate.  :func:`launch_shape` mirrors how the
``.cu`` file sizes the launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from esa_pose_estimation_tpu_torch import _build

_EPS = 1e-10
# Mirrors of csrc/peak_decode.cu (tests/test_torch_peak.py checks them).
_MAX_RANKS = 16           # kMaxRanks: CTAs (bands) per image, at most
_MAX_THREADS = 512        # kMaxThreads
_ERRORS = {-1: 'no block size fits this K, or the maps are too large',
           -3: 'no cluster of this many CTAs can be placed on the card',
           -4: 'the card\'s index is past the kernel\'s per-device table'}


def block_threads(k: int, vec: int) -> int:
    """Threads per CTA: the largest multiple of lcm(32, k / gcd(k, vec))
    up to ``_MAX_THREADS`` (so threads * vec is a multiple of k); 0 if
    none fits."""
    unit = math.lcm(32, k // math.gcd(k, vec))
    return 0 if unit > _MAX_THREADS else _MAX_THREADS // unit * unit


def launch_shape(b: int, h: int, w: int, k: int, n_sm: int,
                 aligned: bool = True) -> tuple[int, int, int, int]:
    """(CTAs per image, rows per band, floats per load, threads per CTA)
    of the kernel's launch for (b, h, w, k) maps on a card of ``n_sm``
    SMs; ``aligned``: the base address is a multiple of 16 bytes.  CTAs
    per image start at 1 and double while the doubled grid has no more
    CTAs than SMs (at most ``_MAX_RANKS`` and h)."""
    ranks = 1
    while 2 * b * ranks <= n_sm and 2 * ranks <= min(_MAX_RANKS, h):
        ranks *= 2
    band = -(-h // ranks)
    if aligned and (w * k) % 4 == 0 and block_threads(k, 4):
        return ranks, band, 4, block_threads(k, 4)
    return ranks, band, 1, block_threads(k, 1)


_fns: dict = {}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load('peak_decode'), name)
        if name == 'peak_decode_launch':
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                           + [ctypes.c_void_p] * 3
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_longlong] * 4
                           + [ctypes.c_int] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def cluster_config(b: int, h: int, w: int, k: int, ranks: int = 0) -> dict:
    """On the card: the launch of 16-byte aligned (b, h, w, k) maps, as
    ``{'ranks', 'threads', 'vec', 'max_active_clusters'}``.  ``ranks`` = 0
    takes the kernel's own choice."""
    out = [ctypes.c_int() for _ in range(4)]
    err = _entry('peak_decode_config')(1, b, h, w, k, ranks,
                                       *(ctypes.byref(o) for o in out))
    _build.check(err, 'peak_decode_config', _ERRORS)
    return dict(zip(('ranks', 'threads', 'vec', 'max_active_clusters'),
                    (o.value for o in out)))


def _launch(hm: torch.Tensor, return_peaks: bool = False, ranks: int = 0):
    """One launch on contiguous f32 CUDA maps; ``ranks`` = 0 takes the
    kernel's own cluster size.  Any other ``ranks`` is for
    ``cli/mfu_experiments --cluster-sweep`` alone, which re-derives the
    default on another card.  Counts nothing."""
    b, h, w, k = hm.shape
    coords = torch.empty((b, k, 2), dtype=torch.float32, device=hm.device)
    maxvals = torch.empty((b, k), dtype=torch.float32, device=hm.device)
    peaks = (torch.empty((b, k), dtype=torch.int32, device=hm.device)
             if return_peaks else None)
    if hm.numel() > 0:
        # the .cu keeps its launch state per device, the runtime's current
        # one: make it the maps' card
        with torch.cuda.device(hm.device):
            err = _entry('peak_decode_launch')(
                hm.data_ptr(), b, h, w, k, coords.data_ptr(),
                maxvals.data_ptr(), peaks.data_ptr() if return_peaks else None,
                _EPS, ranks, torch.cuda.current_stream(hm.device).cuda_stream)
        _build.check(err, f'peak_decode on {hm.device}', _ERRORS)
    return (coords, maxvals, peaks) if return_peaks else (coords, maxvals)


def peak_decode(heatmaps: torch.Tensor, return_peaks: bool = False):
    """Decode (B, H, W, K) maps -> (coords (B, K, 2) as (x, y), maxvals
    (B, K)), both float32.  ``return_peaks`` adds the integer peaks'
    row-major indices (B, K) int32, for checking.

    A CUDA tensor launches the kernel, which reads contiguous float32
    maps: other dtypes are upcast, and maps of any other strides are first
    copied once by ``.contiguous()`` (a layout step; the network's output
    is already contiguous).  A CPU tensor takes the plain version.  Any
    other device raises.
    """
    if heatmaps.dim() != 4:
        raise ValueError(f'expected (B, H, W, K) maps, got {heatmaps.shape}')
    if heatmaps.device.type == 'cpu':
        from esa_pose_estimation_tpu_torch.ops import peak
        nchw = heatmaps.permute(0, 3, 1, 2)
        coords, maxvals = peak.decode_heatmaps(nchw)
        if not return_peaks:
            return coords, maxvals
        ipk, _ = peak.argmax_peaks(nchw)
        idx = ipk[..., 1] * heatmaps.shape[2] + ipk[..., 0]
        return coords, maxvals, idx.to(torch.int32)
    if heatmaps.device.type != 'cuda':
        raise RuntimeError(f'peak_decode: unsupported device {heatmaps.device}')
    if not heatmaps.is_floating_point():
        raise TypeError(f'peak_decode: float maps expected, got {heatmaps.dtype}')
    hm = heatmaps.to(torch.float32).contiguous()   # the TPU kernel upcasts too
    out = _launch(hm, return_peaks)
    if hm.numel() > 0:
        peak_decode.launches += 1
    return out


peak_decode.launches = 0
