"""Eval-time HRNet fuse-layer conv merging (port of the JAX package's
``experimental/merged_fuse.py``).

The composite ``FuseLayer`` (models/hrnet.py) runs up to n*(n-1) narrow
convs, each with its BN affine.  The merged program folds each path's
eval-time BN into its conv (exact: BN of frozen statistics is a
per-channel affine) and runs the paths that read the SAME source branch as
one wider conv, whose output is sliced per path: all 1x1 up-projections
of branch j become one 1x1 conv, and the first 3x3/s2 conv of every
downsample chain from branch j one 3x3/s2 conv.

The arithmetic is the JAX merged program's: the conv runs in the model
dtype with the folded kernel cast to it, and the folded bias is added in
that dtype.  ``models.hrnet.FuseLayer`` dispatches here when
``hrnet.MERGED_FUSE`` is set and the module is not training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fuse_path_specs(num_branches: int) -> dict[tuple[int, int], list[int]]:
    """FuseLayer's construction order: (target i, source j) -> the
    ``ConvBN_<n>`` indices along that path (1 for an up-path j > i, i - j
    for a downsample chain)."""
    specs: dict[tuple[int, int], list[int]] = {}
    idx = 0
    for i in range(num_branches):
        for j in range(num_branches):
            if j == i:
                continue
            n = 1 if j > i else i - j
            specs[(i, j)] = list(range(idx, idx + n))
            idx += n
    return specs


def _folded(mod, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ConvBN_<k>'s OIHW kernel with its eval-time BN affine folded in."""
    cb = getattr(mod, f'ConvBN_{k}')
    bn = cb.BatchNorm_0
    eff = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    kernel = cb.Conv_0.weight.to(torch.float32) * eff[:, None, None, None]
    return kernel, bn.bias - bn.running_mean * eff


def _conv(mod, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          stride: int) -> torch.Tensor:
    y = F.conv2d(x.to(mod.dtype), kernel.to(mod.dtype), stride=stride,
                 padding=kernel.shape[-1] // 2)
    return y + bias.to(mod.dtype)[:, None, None]


def merged_fuse(mod, xs: list[torch.Tensor], resize_bilinear
                ) -> list[torch.Tensor]:
    """Run ``mod`` (a FuseLayer) through the merged eval program; xs and
    the outputs are NCHW."""
    n = mod.num_branches
    specs = fuse_path_specs(n)
    # contributions[i][j] = path_ij(xs[j]) at branch i's resolution
    contributions: list[dict[int, torch.Tensor]] = [{} for _ in range(n)]
    for j in range(n):
        ups = [i for i in range(n) if i < j]
        if ups:  # all 1x1 up-projections of xs[j] as one conv
            ks, bs = zip(*(_folded(mod, specs[(i, j)][0]) for i in ups))
            y = _conv(mod, xs[j], torch.cat(ks, 0), torch.cat(bs), 1)
            off = 0
            for i in ups:
                sl = y[:, off:off + mod.channels[i]]
                off += mod.channels[i]
                contributions[i][j] = resize_bilinear(
                    sl, tuple(xs[i].shape[2:4]), align_corners=False)
        downs = [i for i in range(n) if i > j]
        if downs:  # every chain's first 3x3/s2 conv as one conv
            head_ch = [mod.channels[i] if i == j + 1 else mod.channels[j]
                       for i in downs]
            ks, bs = zip(*(_folded(mod, specs[(i, j)][0]) for i in downs))
            y = _conv(mod, xs[j], torch.cat(ks, 0), torch.cat(bs), 2)
            off = 0
            for i, ch in zip(downs, head_ch):
                path = y[:, off:off + ch]
                off += ch
                if i - j > 1:      # ReLU between chain convs, then the
                    path = torch.relu(path)   # rest of the chain
                    for lvl, idx in enumerate(specs[(i, j)][1:], start=1):
                        path = _conv(mod, path, *_folded(mod, idx), 2)
                        if lvl < i - j - 1:
                            path = torch.relu(path)
                contributions[i][j] = path
    outs = []
    for i in range(n):  # the composite's j-order summation, xs[i] at j == i
        y = None
        for j in range(n):
            path = xs[i] if j == i else contributions[i][j]
            y = path if y is None else y + path
        outs.append(torch.relu(y).to(mod.dtype))
    return outs
