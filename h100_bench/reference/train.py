"""The plain reference of the training steps: the network in training
mode (batch statistics, running statistics updated), the weighted
HeatmapWing loss, its backward and ``torch.optim.Adam`` (betas 0.9/0.999,
eps 1e-8) at a constant rate, one step per batch, eagerly.

``low=True`` runs the convolutions on fp8 operands (``net.FP8``), one
precision below the configuration's bf16: the check's control.
"""

from __future__ import annotations

import torch

from h100_bench.reference import net
from h100_bench.reference.loss import weighted_heatmap_loss


def run_steps(model: net.HRNet, batches: list[dict], lr: float,
              loss_w: float, low: bool = False,
              adam: dict[str, dict] | None = None):
    """Train ``model`` in place, one Adam step per batch, from Adam's
    state ``adam`` (per parameter name its ``exp_avg``, ``exp_avg_sq`` and
    ``step``; a fresh optimizer where None).  Returns the losses
    (len(batches),) and the optimizer."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for name, p in (model.named_parameters() if adam else ()):
        st = adam[name]
        opt.state[p] = {'step': torch.tensor(float(st['step'])),
                        'exp_avg': torch.empty_like(p).copy_(st['exp_avg']),
                        'exp_avg_sq': torch.empty_like(p).copy_(
                            st['exp_avg_sq'])}
    model.train()
    losses = []
    prev, net.FP8 = net.FP8, low
    try:
        for b in batches:
            loss = weighted_heatmap_loss(model(b['image']), b['heatmaps'],
                                         b['weights'], W=loss_w)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    finally:
        net.FP8 = prev
    return torch.stack(losses), opt
