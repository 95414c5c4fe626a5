"""Branch chain on Hopper: k residual BasicBlocks with BN folded in.

Replaces the TPU kernel ``esa_pose_estimation_tpu/experimental/branch_chain.py``
``branch_chain_pallas`` (body ``_kernel``).  The CUDA source is
``csrc/branch_chain.cu``; :func:`branch_chain_plain` is the plain PyTorch
version (the counterpart of the JAX ``branch_chain_xla``).  Eval-time
semantics, per block ``i``::

    h = relu(conv3x3(x, w[i, 0]) + b[i, 0])            rounded to x's dtype
    x = relu(conv3x3(h, w[i, 1]) + b[i, 1] + x)        rounded to x's dtype

with f32 accumulation and the residual read as f32.

Bound on the card: operations (2k 3x3 convs at C = 32; 154.6 GFLOP against
134 MB at batch 256, 64x64).  The TPU kernel pins a whole (T, 64, 64, 32)
block in VMEM; a Hopper block cannot hold one image (256 KB in bf16), so
both kernels run one launch per residual block over output tiles with a
2-pixel halo in shared memory.  bf16 goes to an implicit GEMM on the tensor
cores (``wgmma``, 16x32 tiles staged ``_WS`` positions wide, weights packed
by :func:`pack_weights`); f32 to FMA on the CUDA cores (16x16 tiles).

The chain is an experiment of its own (``cli/mfu_experiments.py --chain``);
no model calls it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from esa_pose_estimation_tpu_torch import _build

_C = 32           # the only channel count the kernel takes
# the bf16 kernel's tile geometry, mirrored from csrc/branch_chain.cu (the
# CPU tests emulate the kernel with these)
_TILE_H, _TILE_W = 16, 32                    # output tile (kTileH, kTileW)
_WS = _TILE_W + 4                            # staged row width (kWs)
_M = 64                                      # positions per wgmma (kM)
_H_MTILES = -(-(_TILE_H + 2) * _WS // _M)    # M tiles of h (kHMTiles)
_O_MTILES = -(-_TILE_H * _WS // _M)          # M tiles of the output
_X_POS = (_H_MTILES * _M + 2 * _WS + 2 + 15) // 16 * 16   # staged x (kXPos)
_ERRORS = {-4: 'the card\'s index is past the kernel\'s per-device table'}
_fns: dict = {}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load('branch_chain'), name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _conv3x3_f32(x_nchw: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x_nchw, w_hwio.permute(3, 2, 0, 1), padding=1)


def branch_chain_plain(x: torch.Tensor, weights: torch.Tensor,
                       biases: torch.Tensor) -> torch.Tensor:
    """The k-block residual chain as f32 convolutions.

    x: (B, H, W, C) NHWC; weights: (k, 2, 3, 3, C, C) HWIO; biases:
    (k, 2, C).  Operands are rounded to x's dtype (as JAX casts the weights)
    and upcast to f32, which is exact; the bias is added to the f32 result
    before the rounding to x's dtype, at the same two places per block as
    JAX.  (``F.conv2d`` on bf16 tensors would round before the bias.)
    """
    dt = x.dtype
    w = weights.to(dt).to(torch.float32)
    b = biases.to(device=x.device, dtype=torch.float32)
    cur = x.permute(0, 3, 1, 2)                                # NCHW view
    for i in range(weights.shape[0]):
        xf = cur.to(torch.float32)
        h = _conv3x3_f32(xf, w[i, 0]) + b[i, 0][:, None, None]
        h = torch.relu(h).to(dt)
        y = _conv3x3_f32(h.to(torch.float32), w[i, 1]) + b[i, 1][:, None, None]
        cur = torch.relu(y + xf).to(dt)
    return cur.permute(0, 2, 3, 1).contiguous()


def pack_weights(weights: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weight order, on the weights' device.

    (k, 2, 3, 3, C, C) HWIO -> contiguous bf16 (k, 2, 9, C // 8, C, 8) with
    ``packed[i, j, t, g, co, c] = weights[i, j, t // 3, t % 3, 8 g + c, co]``
    (rounded to bf16, as JAX casts them).  For conv j of block i and tap t,
    ``packed[i, j, t]`` is the B operand of ``wgmma`` in K-major no-swizzle
    core matrices: per group g of 8 input channels, the C output channels
    as rows of 16 bytes.
    """
    k, _, _, _, cin, cout = weights.shape
    w = weights.to(torch.bfloat16).reshape(k, 2, 9, cin // 8, 8, cout)
    return w.permute(0, 1, 2, 3, 5, 4).contiguous()


def branch_chain(x: torch.Tensor, weights: torch.Tensor,
                 biases: torch.Tensor) -> torch.Tensor:
    """The k-block residual chain (the :func:`branch_chain_plain` function).

    A CUDA tensor launches the kernel: x contiguous and 16-byte aligned
    (B, H, W, 32) bf16 (tensor cores) or f32 (FMA); weights
    (k, 2, 3, 3, 32, 32) and biases (k, 2, 32) of any float type.  A CPU
    tensor takes the plain version.  Any other device raises.
    """
    if x.device.type == 'cpu':
        return branch_chain_plain(x, weights, biases)
    if x.device.type != 'cuda':
        raise RuntimeError(f'branch_chain: unsupported device {x.device}')
    if (x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32)
            or not x.is_contiguous()):
        raise ValueError('branch_chain: x must be a contiguous bf16 or f32 '
                         f'(B, H, W, C) tensor, got {x.dtype} '
                         f'{tuple(x.shape)} strides {x.stride()}')
    b_, h, w_, c = x.shape
    if c != _C:
        raise ValueError(f'branch_chain: the kernel takes C={_C}, got C={c}')
    k = weights.shape[0]
    if weights.shape != (k, 2, 3, 3, c, c) or biases.shape != (k, 2, c):
        raise ValueError(f'branch_chain: weight shapes {tuple(weights.shape)} '
                         f'{tuple(biases.shape)} do not fit C={c}')
    if x.data_ptr() % 16:
        raise ValueError('branch_chain: x must be 16-byte aligned')
    dev = x.device
    if x.dtype == torch.bfloat16:
        name, wk = 'branch_chain_bf16_launch', pack_weights(weights.to(dev))
    else:
        name = 'branch_chain_f32_launch'
        wk = weights.to(device=dev, dtype=torch.float32).contiguous()
    bf = biases.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0 or k == 0:
        return out.copy_(x)
    scratch = torch.empty_like(x) if k > 1 else None
    # the .cu keeps its launch state per device, the runtime's current
    # one: make it x's card
    with torch.cuda.device(dev):
        err = _entry(name)(x.data_ptr(), out.data_ptr(),
                           scratch.data_ptr() if scratch is not None else None,
                           wk.data_ptr(), bf.data_ptr(), b_, h, w_, k,
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f'branch_chain on {dev}', _ERRORS)
    branch_chain.launches += 1
    return out


branch_chain.launches = 0


def make_test_chain(generator: torch.Generator, k: int = 4, c: int = 32,
                    scale: float = 0.2, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Random folded-BN chain weights sized so activations stay O(1)
    (the JAX ``make_test_chain``, drawn from ``generator``)."""
    weights = scale * torch.randn((k, 2, 3, 3, c, c), generator=generator,
                                  device=device) / (9.0 * c) ** 0.5
    biases = 0.1 * torch.randn((k, 2, c), generator=generator, device=device)
    return weights, biases
