"""Fused CBAM gate (+ residual add + ReLU) on Hopper, inference only.

Replaces the TPU kernel ``esa_pose_estimation_tpu/experimental/cbam_fuse.py``
``fused_cbam_pallas`` (body ``_kernel``).  The CUDA source is
``csrc/cbam_fuse.cu``; :func:`cbam_plain` is the plain PyTorch version
(the f32 straight line the JAX tests hold the TPU kernel to).

Bound on the card: bytes (x and residual read, the output written, bf16;
a few dozen operations per element).  A Hopper block cannot hold a whole
image's map the way the TPU kernel holds it in VMEM, so the kernel runs
as four launches on the current stream: partial channel pools, the
per-image MLP gate, the per-pixel channel pools, and a tiled 7x7 conv +
apply pass.  It reads x three times; fewer passes are later work.

``models/layers.CBAM`` dispatches here when ``layers.FUSED_CBAM`` is set
and the module is not training.  There is no autograd through it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu_torch import _build

_CHUNK = 128      # pixels per pooling block, csrc/cbam_fuse.cu kChunk
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load('cbam_fuse').cbam_fuse_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cbam_plain(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
               spw: torch.Tensor, residual: torch.Tensor | None = None
               ) -> torch.Tensor:
    """f32 straight-line CBAM on NHWC maps: channel gate, spatial gate,
    optional ``relu(. + residual)``; returns ``x.dtype``.

    x, residual: (B, H, W, C); fc1 (C, C/16); fc2 (C/16, C); spw (7, 7, 2)
    with the channel-mean map first.
    """
    xf = x.to(torch.float32)
    avg = xf.mean(dim=(1, 2))                          # (B, C)
    mx = xf.amax(dim=(1, 2))
    fc1 = fc1.to(torch.float32)
    fc2 = fc2.to(torch.float32)

    def mlp(v):
        return torch.relu(v @ fc1) @ fc2

    cg = torch.sigmoid(mlp(avg) + mlp(mx))[:, None, None, :]
    xg = xf * cg
    s = torch.stack([xg.mean(dim=-1), xg.amax(dim=-1)], dim=1)   # (B, 2, H, W)
    w = spw.to(torch.float32).permute(2, 0, 1)[None]             # (1, 2, 7, 7)
    sg = torch.sigmoid(F.conv2d(s, w, padding=3))[:, 0, :, :, None]
    out = xg * sg
    if residual is not None:
        out = torch.relu(out + residual.to(torch.float32))
    return out.to(x.dtype)


def fused_cbam(x: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
               spw: torch.Tensor, residual: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Fused CBAM on NHWC maps (the :func:`cbam_plain` function).

    A CUDA tensor launches the kernel: x and residual contiguous bf16
    (B, H, W, C), weights of any float type.  A CPU tensor takes the plain
    version.  Any other device raises.
    """
    if x.device.type == 'cpu':
        return cbam_plain(x, fc1, fc2, spw, residual)
    if x.device.type != 'cuda':
        raise RuntimeError(f'fused_cbam: unsupported device {x.device}')
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError('fused_cbam: x must be a contiguous bf16 (B, H, W, C) '
                         f'tensor, got {x.dtype} {tuple(x.shape)} '
                         f'strides {x.stride()}')
    b, h, w, c = x.shape
    hid = fc1.shape[-1]
    if fc1.shape != (c, hid) or fc2.shape != (hid, c) or spw.shape != (7, 7, 2):
        raise ValueError(f'fused_cbam: weight shapes {tuple(fc1.shape)} '
                         f'{tuple(fc2.shape)} {tuple(spw.shape)} do not fit '
                         f'C={c}')
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError('fused_cbam: residual must match x (contiguous bf16)')
    dev = x.device
    fc1 = fc1.to(device=dev, dtype=torch.float32).contiguous()
    fc2 = fc2.to(device=dev, dtype=torch.float32).contiguous()
    spw = spw.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    n_chunks = -(-(h * w) // _CHUNK)
    psum = torch.empty((b, n_chunks, c), dtype=torch.float32, device=dev)
    pmax = torch.empty_like(psum)
    cg = torch.empty((b, c), dtype=torch.float32, device=dev)
    pooled = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return out
    err = _entry()(x.data_ptr(),
                   residual.data_ptr() if residual is not None else None,
                   fc1.data_ptr(), fc2.data_ptr(), spw.data_ptr(),
                   out.data_ptr(), psum.data_ptr(), pmax.data_ptr(),
                   cg.data_ptr(), pooled.data_ptr(), b, h, w, c, hid,
                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, 'fused_cbam')
    fused_cbam.launches += 1
    return out


fused_cbam.launches = 0
