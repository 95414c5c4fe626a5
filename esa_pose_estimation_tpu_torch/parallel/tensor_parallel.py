"""Output-channel tensor parallelism: the collectives around a conv whose
output channels are split over the ``model`` axis of a process mesh
(``parallel/mesh.shard_state``).

Rank j of a model group of n holds rows ``[j*O/n, (j+1)*O/n)`` of the
conv's (O, I, kh, kw) weight and computes those output channels from the
whole input.  Two autograd functions join the slices, as XLA's GSPMD
joins them around JAX's ``param_sharding``:

* :func:`copy_to_model` on the input: the identity forward; the backward
  sums over the model group the input gradients the ranks computed from
  their slices (one all-reduce).
* :func:`gather_from_model` on the output: an all-gather of the slices,
  so BatchNorm, CBAM and the next conv see every channel, laid out as the
  unsplit conv's output (NCHW in ``channels_last``, channel k at its
  place).  The backward keeps this rank's slice of the output gradient,
  with no reduction: downstream of the gather every rank of the group
  computes the same full gradient.  ``torch.distributed.nn.functional.
  all_gather`` is not used: its backward sums the output gradients over
  the group, which would scale the split weights' gradients by n.

Everything is gathered once after each split conv; BatchNorm and ReLU
stay replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Axis:
    """One mesh axis as a module sees it: the process group over the
    axis (None: the whole group), its size and this rank's place on it.
    A deep copy of a module shares it, as it shares the process group."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def __deepcopy__(self, memo) -> Axis:
        return self


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = torch.empty_like(grad)
        out.copy_(grad)
        dist.all_reduce(out, group=ctx.axis.group)
        return out, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, axis: Axis) -> torch.Tensor:
        ctx.axis, ctx.width = axis, y.shape[1]
        local = y.permute(0, 2, 3, 1).contiguous()         # NHWC
        parts = [torch.empty_like(local) for _ in range(axis.size)]
        dist.all_gather(parts, local, group=axis.group)
        return torch.cat(parts, dim=3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        lo = ctx.axis.index * ctx.width
        mine = grad.narrow(1, lo, ctx.width)
        return mine.contiguous(memory_format=torch.channels_last), None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``axis``'s group."""
    return _CopyToModel.apply(x, axis)


def gather_from_model(y: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The NCHW slices ``y`` of the ranks of ``axis`` joined along the
    channels in rank order, ``channels_last``; the gradient of this
    rank's slice back."""
    return _GatherFromModel.apply(y, axis)
