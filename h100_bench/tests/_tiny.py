"""A cell's run on the CPU at ``hrnet_tiny`` size, for the harness's
tests: the cell's own files with the network, the pool and the steps cut
down, the look for a card skipped, and limits set for this size."""

from __future__ import annotations

import torch

from h100_bench import harness, run

SERVE_LIMITS = {'heatmap_gap': 1e-4, 'keypoint_gap_px': 1e-3,
                'confidence_gap': 1e-4, 'rotation_gap_p99_rad': 1e-5,
                'translation_gap_p99': 1e-5}
# the port's half-pixel resize has a backward of its own, which rounds
# otherwise in bf16 than autograd's
_CALL = {'loss_gap': 1e-3, 'grad_gap': 0.05, 'update_gap': 0.05,
         'stats_gap': 1e-3, 'grad_gap_p90': 0.05, 'update_gap_p90': 0.05,
         'stats_gap_p90': 1e-3}
TRAIN_LIMITS = {p + k: v for p in ('', 'window_') for k, v in _CALL.items()}
RANKS_LIMITS = TRAIN_LIMITS


def artifact(path: str) -> str:
    """A seeded ``hrnet_tiny`` written as the npz the benchmark reads."""
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.utils import config as pcfg
    from esa_pose_estimation_tpu_torch.utils.artifact import (
        save_inference_artifact,
    )
    model = HRNet(pcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0))
    save_inference_artifact(path, model, {'model': 'hrnet_tiny'})
    return path


def context(cell: str, weights: str, seed: int = 2**33 + 7,
            world: int = 1, rank: int = 0, port: int = 0):
    wl = harness.workload(cell)
    cfg = harness.config(wl['config'])
    cfg.update(model='hrnet_tiny', num_keypoints=6, stem_channels=8,
               widths=[8, 16, 32, 64], blocks=[1, 1, 1, 1], weights=weights)
    tr = wl['traffic']
    if wl['driver'] == 'serve_closed':
        tr.update(batch=min(tr['batch'], 4), pool_frames=8, check_frames=6,
                  warm_up_calls=1)
        wl['limits'] = dict(SERVE_LIMITS)
    else:
        tr.update(batch=4, pool_batches=4, n_inner=2, warm_up_calls=2)
        wl['limits'] = dict(TRAIN_LIMITS if world == 1 else RANKS_LIMITS)
    wl['chips'] = world
    return run.make_context(cell, seed, 1.0, False, 'cpu', rank=rank,
                            port=port, wl=wl, cfg=cfg)


def child(cell: str, weights: str, world: int, rank: int, port: int,
          out: str, no_exchange: bool) -> None:
    """One rank of a several-process training run over gloo; rank 0
    writes the result's ``correct`` and numbers to ``out``.  With
    ``no_exchange`` the ranks train apart: no DDP, local statistics."""
    import json

    torch.set_num_threads(1)
    if no_exchange:
        from esa_pose_estimation_tpu_torch.models import layers
        from esa_pose_estimation_tpu_torch.parallel import mesh
        mesh.wrap_data_parallel = lambda model, mesh=None: model
        layers._in_group = lambda: False
    res = run.run_cell(context(cell, weights, world=world, rank=rank,
                               port=port))
    if rank == 0:
        with open(out, 'w') as f:
            json.dump({'correct': res['correct'],
                       'numbers': res['numbers']}, f)
