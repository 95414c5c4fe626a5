"""Train state, the stepped learning-rate schedule, and the train and eval
steps (torch port of the JAX package's ``train/state.py``; reference
main.py:237-424).

Adam at optax's defaults (betas 0.9/0.999, eps 1e-8) with the stepped epoch
schedule (main.py:298-299 through adjust_learning_rate :223-234), and the
weighted HeatmapWing loss (loss.py:116-129); the detector's cosine decay
(:func:`cosine_schedule`).  Several processes train one model through
``TrainState.train_model``, the ``DistributedDataParallel`` wrapper of
``parallel/mesh.wrap_data_parallel``, whose backward averages the
gradients over the processes.  The JAX package's mesh and scan steps have
no counterpart here (the train loop keeps per-step losses on the device
instead, ``cli/train.py``).
"""

from __future__ import annotations

from typing import Callable

import math

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


def cosine_schedule(lr: float, total_steps: int, alpha: float = 0.01
                    ) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, total_steps, alpha)``: from ``lr``
    down to ``alpha * lr`` along a half cosine over ``total_steps``, then
    flat; the constant ``lr`` when ``total_steps`` is 0."""
    if total_steps <= 0:
        return lambda step: lr

    def schedule(step: int) -> float:
        frac = min(step, total_steps) / total_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                     + alpha)

    return schedule


class TrainState:
    """The model, its Adam optimizer, the schedule and the step count (the
    number of optimizer updates so far, optax's ``count``).  An evaluation
    holds the model alone (``optimizer=None``).

    ``train_model`` is what a train step runs forward: the model itself, or
    its ``DistributedDataParallel`` wrapper when several processes train
    it (``parallel/mesh.wrap_data_parallel``).  Checkpoints hold ``model``,
    so their names do not depend on the wrapper."""

    def __init__(self, model: nn.Module,
                 optimizer: torch.optim.Optimizer | None = None,
                 schedule: Callable[[int], float] | None = None,
                 step: int = 0):
        self.model = model
        self.train_model: nn.Module = model
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
    loss and the gradients' global norm as device tensors: no host sync.
    Under several processes the loss is this process's and the norm is
    that of the gradients averaged over the processes."""
    return optimize(state, lambda model: weighted_heatmap_loss(
        model(batch['image']), batch['heatmaps'], batch['weights'],
        W=loss_w))


def optimize(state: TrainState,
             loss_fn: Callable[[nn.Module], torch.Tensor]
             ) -> dict[str, torch.Tensor]:
    """One Adam step on ``loss_fn(state.train_model)``, a train-mode
    forward and its scalar loss: the backward (``DistributedDataParallel``
    averages the gradients over the processes inside it), the gradients'
    global norm, the update at the schedule's rate for this step.  Returns
    the loss and the norm as device tensors."""
    model, opt = state.train_model, state.optimizer
    model.train()
    loss = loss_fn(model)
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
