"""Train state, the stepped learning-rate schedule, and the train and eval
steps (torch port of the JAX package's ``train/state.py``; reference
main.py:237-424).

Adam at optax's defaults (betas 0.9/0.999, eps 1e-8) with the stepped epoch
schedule (main.py:298-299 through adjust_learning_rate :223-234), and the
weighted HeatmapWing loss (loss.py:116-129).  One card, one process: the
JAX package's mesh and scan steps have no counterpart here (the train loop
keeps per-step losses on the device instead, ``cli/train.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from esa_pose_estimation_tpu_torch.train.loss import weighted_heatmap_loss
from esa_pose_estimation_tpu_torch.utils.config import TrainConfig


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int
                ) -> Callable[[int], float]:
    """Stepped schedule as a function of the optimizer step: lr_values[i]
    from epoch lr_boundaries[i-1] on (absolute values, main.py:298-299),
    ``optax.piecewise_constant_schedule``'s rule: a boundary's scale applies
    once ``step >= boundary``.

    Duplicate boundaries (a short run rescales epochs and can collide, e.g.
    --epochs 2 gives (2, 2, 3)) compose their scales at the shared step, so
    every prescribed decade of decay applies.  Mismatched value and
    boundary counts raise.
    """
    if len(cfg.lr_values) != len(cfg.lr_boundaries) + 1:
        raise ValueError(
            f'need len(lr_values) == len(lr_boundaries) + 1, got '
            f'{len(cfg.lr_values)} values / {len(cfg.lr_boundaries)} '
            f'boundaries')
    scales: dict[int, float] = {}
    prev = cfg.lr_values[0]
    for epoch, value in zip(cfg.lr_boundaries, cfg.lr_values[1:]):
        step = epoch * steps_per_epoch
        scales[step] = scales.get(step, 1.0) * (value / prev)
        prev = value
    init = cfg.lr_values[0]

    def schedule(step: int) -> float:
        lr = init
        for boundary, scale in scales.items():
            if step >= boundary:
                lr *= scale
        return lr

    return schedule


class TrainState:
    """The model, its Adam optimizer, the schedule and the step count (the
    number of optimizer updates so far, optax's ``count``).  An evaluation
    holds the model alone (``optimizer=None``)."""

    def __init__(self, model: nn.Module,
                 optimizer: torch.optim.Optimizer | None = None,
                 schedule: Callable[[int], float] | None = None,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Adam (optax's defaults) over ``model``'s parameters, which must
    already be on their device, at the schedule's rate."""
    schedule = lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt, schedule)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def train_step(state: TrainState, batch: dict[str, torch.Tensor],
               loss_w: float = 10.0) -> dict[str, torch.Tensor]:
    """One optimization step on batch {'image': (B, H, W, C), 'heatmaps':
    (B, H, W, K), 'weights': (B, H, W, K)}: a train-mode forward (batch
    statistics; the BatchNorm running statistics update), the loss, its
    gradients, Adam at the schedule's rate for this step.  Returns the
    loss and the gradients' global norm as device tensors: no host sync."""
    model, opt = state.model, state.optimizer
    model.train()
    out = model(batch['image'])
    loss = weighted_heatmap_loss(out, batch['heatmaps'], batch['weights'],
                                 W=loss_w)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = global_norm([p.grad for p in model.parameters()
                             if p.grad is not None])
    lr = state.schedule(state.step)
    for group in opt.param_groups:
        group['lr'] = lr
    opt.step()
    state.step += 1
    return {'loss': loss.detach(), 'grad_norm': grad_norm.detach()}


@torch.no_grad()
def eval_step(state: TrainState, batch: dict[str, torch.Tensor],
              loss_w: float = 10.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward + loss with frozen statistics: (heatmaps, loss)."""
    state.model.eval()
    out = state.model(batch['image'])
    return out, weighted_heatmap_loss(out, batch['heatmaps'],
                                      batch['weights'], W=loss_w)
