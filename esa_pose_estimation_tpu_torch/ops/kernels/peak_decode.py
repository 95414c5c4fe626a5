"""Peak decode on Hopper: first-occurrence argmax + log-Taylor refine.

Replaces the TPU kernel ``esa_pose_estimation_tpu/ops/pallas/peak_decode.py``
``decode_heatmaps_pallas`` (body ``_kernel``).  The CUDA source is
``csrc/peak_decode.cu``; the plain PyTorch version is
``ops/peak.decode_heatmaps``.

Bound on the card: bytes.  The function reads every heatmap value once
(B*S*S*K*4 bytes: 503 MB at B=256, S=128, K=30, about 0.15 ms at
3.35 TB/s) and does a handful of operations per value.  The design is the
simple one: one thread block per (image, keypoint) map reads the map
through the strides of the network's channels-last (B, S, S, K) output (so
no transpose pass is needed), reduces (max, first index) block-wide, and
one thread evaluates the 10-tap stencil and the gate.  The strided reads
(4 useful bytes per K*4-byte pixel row) are its known cost.
"""

from __future__ import annotations

import ctypes

import torch

from esa_pose_estimation_tpu_torch import _build

_EPS = 1e-10
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load('peak_decode').peak_decode_launch
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 8
                       + [ctypes.c_void_p] * 3 + [ctypes.c_float,
                                                  ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def peak_decode(heatmaps: torch.Tensor, return_peaks: bool = False):
    """Decode (B, H, W, K) maps of any strides -> (coords (B, K, 2) as
    (x, y), maxvals (B, K)), both float32.  ``return_peaks`` adds the
    integer peaks' row-major indices (B, K) int32, for checking.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version.  Any other device raises.
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
    hm = heatmaps.to(torch.float32)       # the TPU kernel upcasts likewise
    b, h, w, k = hm.shape
    if h * w >= 2 ** 31:
        raise ValueError('peak_decode: map too large for int32 indexing')
    coords = torch.empty((b, k, 2), dtype=torch.float32, device=hm.device)
    maxvals = torch.empty((b, k), dtype=torch.float32, device=hm.device)
    peaks = (torch.empty((b, k), dtype=torch.int32, device=hm.device)
             if return_peaks else None)
    if b * k > 0:
        sb, sh, sw, sk = hm.stride()
        err = _entry()(hm.data_ptr(), b, h, w, k, sb, sh, sw, sk,
                       coords.data_ptr(), maxvals.data_ptr(),
                       peaks.data_ptr() if return_peaks else None, _EPS,
                       torch.cuda.current_stream(hm.device).cuda_stream)
        _build.check(err, 'peak_decode')
        peak_decode.launches += 1
    return (coords, maxvals, peaks) if return_peaks else (coords, maxvals)


peak_decode.launches = 0
