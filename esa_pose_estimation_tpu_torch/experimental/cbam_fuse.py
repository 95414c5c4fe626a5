"""Fused CBAM gate (+ residual add + ReLU) on Hopper, inference only.

Replaces the TPU kernel ``esa_pose_estimation_tpu/experimental/cbam_fuse.py``
``fused_cbam_pallas`` (body ``_kernel``).  The CUDA source is
``csrc/cbam_fuse.cu``; :func:`cbam_plain` is the plain PyTorch version
(the f32 straight line the JAX tests hold the TPU kernel to).

Bound on the card: bytes (x and residual read, the output written, bf16;
a few dozen operations per element).  The kernel is one launch per call:
a thread-block cluster per image, each of its R CTAs holding a band of
``ceil(H / R)`` rows of x in shared memory, read from device memory once.
The CTAs combine their rows' channel pools in row order and exchange the
halo rows of the pooled maps through distributed shared memory.  R per site is
:func:`cluster_ranks` (mirrored from the ``.cu`` file: the table
``_SITE_RANKS``, a band rule for other shapes, and more CTAs per image
when the batch would leave SMs idle).  The kernel reads the convs'
weights where they are stored, f32 masters or the bf16 serving form, and
stages them in f32 shared memory; the wrapper allocates only the output.

Every sum is taken in an order that the site's (H, W, C) fixes, so an
image's output does not depend on R, nor on the batch or shard it is
served in.

``models/layers.CBAM`` dispatches here by ``layers.FUSED_CBAM``'s rule
(``layers.takes_fused_cbam``): on the card, every eval-mode bf16 forward
that needs no gradient, with C a power of two in [8, 4096].  There is no
autograd through it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu_torch import _build

# Mirrors of csrc/cbam_fuse.cu (tests/test_torch_cbam.py checks them).
_THREADS = 512            # kThreads
_MAX_RANKS = 16           # kMaxRanks: CTAs per cluster
_BAND_BYTES = 65536       # kBandBytes: x bytes per CTA of the default rule
_SITE_RANKS = {           # kSiteRanks: (H, W, C) -> R, hrnet_esa's sites
    (64, 64, 32): 5,
    (32, 32, 64): 2,
    (16, 16, 128): 1,
    (8, 8, 256): 1,
    (128, 128, 64): 16,
}
_WEIGHT_DTYPES = {torch.float32: 0,        # kWeightF32
                  torch.bfloat16: 1}       # kWeightBf16
_ERRORS = {-1: 'C must be a power of two in [8, 4096] and H*W < 2^24',
           -2: 'one band of x does not fit a block\'s shared memory',
           -3: 'no cluster of this many CTAs can be placed on the card',
           -4: 'the card\'s index is past the kernel\'s per-device table',
           -5: 'the weights are neither f32 nor bf16'}
_fns: dict = {}


def cluster_ranks(h: int, w: int, c: int, batch: int = 0, n_sm: int = 0
                  ) -> int:
    """CTAs per image (cluster size) the kernel takes for an (h, w, c) map
    (``pick_ranks`` in the ``.cu`` file): the site table, else the
    smallest power of two whose band of bf16 x fits ``_BAND_BYTES`` (at
    most ``_MAX_RANKS`` and at most h); then, for a batch of ``batch`` on
    a card of ``n_sm`` SMs, doubled while the doubled grid has no more
    CTAs than SMs."""
    r = _SITE_RANKS.get((h, w, c), 0)
    if not r:
        r = 1
        while r < _MAX_RANKS and r < h and -(-h // r) * w * c * 2 > _BAND_BYTES:
            r *= 2
    while (batch and 2 * batch * r <= n_sm and 2 * r <= _MAX_RANKS
           and 2 * r <= h):
        r *= 2
    return r


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load('cbam_fuse'), name)
        if name == 'cbam_fuse_launch':
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                           + [ctypes.c_void_p] + [ctypes.c_longlong] * 5
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_longlong] * 5 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def cluster_config(b: int, h: int, w: int, c: int, hid: int,
                   ranks: int = 0) -> dict:
    """On the card: the launch configuration of a batch of b (h, w, c)
    maps with bf16 weights (the serving form), as ``{'ranks',
    'smem_bytes', 'max_active_clusters'}``.  ``ranks`` = 0 takes the
    kernel's own choice."""
    r, smem, clusters = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    err = _entry('cbam_fuse_config')(b, h, w, c, hid,
                                     _WEIGHT_DTYPES[torch.bfloat16], ranks,
                                     ctypes.byref(r), ctypes.byref(smem),
                                     ctypes.byref(clusters))
    _build.check(err, 'cbam_fuse_config', _ERRORS)
    return {'ranks': r.value, 'smem_bytes': smem.value,
            'max_active_clusters': clusters.value}


def cbam_plain(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
               spw: torch.Tensor, residual: torch.Tensor | None = None
               ) -> torch.Tensor:
    """f32 straight-line CBAM on NHWC maps: channel gate, spatial gate,
    optional ``relu(. + residual)``; returns ``x.dtype``.

    x, residual: (B, H, W, C).  The weights are the convs' own, of any
    float dtype: fc1 ChannelAttention's first 1x1 conv (C/16, C, 1, 1),
    fc2 its second (C, C/16, 1, 1), spw SpatialAttention's 7x7 conv
    (1, 2, 7, 7) with the channel-mean map first.
    """
    xf = x.to(torch.float32)
    avg = xf.mean(dim=(1, 2))                          # (B, C)
    mx = xf.amax(dim=(1, 2))
    fc1 = fc1.to(torch.float32)[:, :, 0, 0]            # (C/16, C)
    fc2 = fc2.to(torch.float32)[:, :, 0, 0]            # (C, C/16)

    def mlp(v):
        return torch.relu(v @ fc1.t()) @ fc2.t()

    cg = torch.sigmoid(mlp(avg) + mlp(mx))[:, None, None, :]
    xg = xf * cg
    s = torch.stack([xg.mean(dim=-1), xg.amax(dim=-1)], dim=1)   # (B, 2, H, W)
    sg = torch.sigmoid(F.conv2d(s, spw.to(torch.float32), padding=3)
                       )[:, 0, :, :, None]
    out = xg * sg
    if residual is not None:
        out = torch.relu(out + residual.to(torch.float32))
    return out.to(x.dtype)


def _launch(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
            spw: torch.Tensor, residual: torch.Tensor | None,
            ranks: int = 0) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; ``ranks`` = 0 takes the
    kernel's own cluster size.  Any other ``ranks`` is for
    ``cli/mfu_experiments --cluster-sweep`` alone, which re-derives
    ``_SITE_RANKS`` on another card.  The weights are passed where they
    lie, so an in-place update is read by the next launch (and by a graph's
    next replay).  Counts nothing."""
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError('fused_cbam: x must be a contiguous bf16 (B, H, W, C) '
                         f'tensor, got {x.dtype} {tuple(x.shape)} '
                         f'strides {x.stride()}')
    b, h, w, c = x.shape
    hid = fc1.shape[0]
    if (fc1.shape != (hid, c, 1, 1) or fc2.shape != (c, hid, 1, 1)
            or spw.shape != (1, 2, 7, 7)):
        raise ValueError(f'fused_cbam: weight shapes {tuple(fc1.shape)} '
                         f'{tuple(fc2.shape)} {tuple(spw.shape)} do not fit '
                         f'C={c}')
    if (fc2.dtype != fc1.dtype or spw.dtype != fc1.dtype
            or fc1.dtype not in _WEIGHT_DTYPES):
        raise ValueError('fused_cbam: the weights must be all f32 or all '
                         f'bf16, got {fc1.dtype} {fc2.dtype} {spw.dtype}')
    if any(t.device != x.device for t in (fc1, fc2, spw)):
        raise ValueError('fused_cbam: the weights must be on x\'s device')
    # the 1x1 convs' rows are read as dense (out, in) matrices
    if fc1.stride()[:2] != (c, 1) or fc2.stride()[:2] != (hid, 1):
        raise ValueError('fused_cbam: the 1x1 conv weights must be dense')
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError('fused_cbam: residual must match x (contiguous bf16)')
    for t in (x, residual):
        if t is not None and t.data_ptr() % 16:
            raise ValueError('fused_cbam: x and residual must be 16-byte '
                             'aligned')
    dev = x.device
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # the .cu keeps its launch state per device, the runtime's current
    # one: make it x's card
    with torch.cuda.device(dev):
        err = _entry('cbam_fuse_launch')(
            x.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            fc1.data_ptr(), fc2.data_ptr(), spw.data_ptr(), *spw.stride()[1:],
            out.data_ptr(), b, h, w, c, hid, _WEIGHT_DTYPES[fc1.dtype], ranks,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f'fused_cbam on {dev}', _ERRORS)
    return out


def fused_cbam(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
               spw: torch.Tensor, residual: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Fused CBAM on NHWC maps (the :func:`cbam_plain` function).

    A CUDA tensor launches the kernel once: x and residual contiguous,
    16-byte aligned bf16 (B, H, W, C) with C a power of two in [8, 4096];
    the convs' weights as :func:`cbam_plain` takes them, all f32 or all
    bf16, on x's card.  A CPU tensor takes the plain version.  Any other
    device raises.
    """
    if x.device.type == 'cpu':
        return cbam_plain(x, fc1, fc2, spw, residual)
    if x.device.type != 'cuda':
        raise RuntimeError(f'fused_cbam: unsupported device {x.device}')
    out = _launch(x, fc1, fc2, spw, residual)
    if x.numel() > 0:
        fused_cbam.launches += 1
    return out


fused_cbam.launches = 0
