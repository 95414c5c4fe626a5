"""Checkpoints with ``last`` / ``best_tran`` / ``best_rotate`` aliases, in a
torch format (port of the JAX package's ``train/checkpoint.py``; reference
main.py:176-204 save_model/load_model, metric-gated best snapshots at
main.py:408-417, eval loading 'best_rotate' at demo.py:418).

Each alias is one file written by ``torch.save``:
``{'model': state_dict, 'optimizer': Adam state_dict or None, 'epoch': int}``,
the reference's {'net', 'optim', 'epoch'}.  The model's parameters are the
f32 masters; the step count is the optimizer's.  ``utils/artifact.py``
maps a JAX train state (params, batch stats, Adam moments) onto this
format and back.
"""

from __future__ import annotations

import json
import os

import torch

from esa_pose_estimation_tpu_torch.parallel.mesh import split_convs
from esa_pose_estimation_tpu_torch.train.state import TrainState

LAST = 'last'
BEST_TRAN = 'best_tran'
BEST_ROTATE = 'best_rotate'


def _plain_state_dict(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict as an eager loop keeps it: a float rate
    and ``capturable`` off, which ``train/state.make_scan_step`` turns
    into a device tensor and on.  A checkpoint then loads on the CPU as on
    the card, and a scan that resumes from it converts it again."""
    sd = opt.state_dict()
    for group in sd['param_groups']:
        if isinstance(group.get('lr'), torch.Tensor):
            group['lr'] = float(group['lr'])
        if 'capturable' in group:
            group['capturable'] = False
    return sd


def _optimizer_step(opt: torch.optim.Optimizer) -> int:
    """Adam's update count (every parameter's 'step' is the same)."""
    for st in opt.state.values():
        return int(st['step'])
    return 0


class CheckpointManager:
    """Aliased checkpoints under ``directory``, which is created at the
    first save (a restore of a missing name leaves no directory behind)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, str(name))

    def exists(self, name: str) -> bool:
        p = self._path(name)
        return os.path.exists(p) or os.path.exists(p + '.old')

    def available(self) -> list[str]:
        """The names in the directory (empty if there is none)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(os.listdir(self.directory))

    def restore_required(self, name: str, state: TrainState
                         ) -> tuple[TrainState, int]:
        """:meth:`restore`, but a missing checkpoint raises: an evaluation
        or a submission must not proceed on initial weights."""
        if not self.exists(name):
            raise FileNotFoundError(
                f'checkpoint {name!r} not found under {self.directory} '
                f'(available: {self.available()})')
        return self.restore(name, state)

    def save(self, name: str, state: TrainState, epoch: int) -> None:
        """Save under an alias ('last', 'best_tran', an epoch number...).

        Crash-safe replacement: the new file is written and synced as
        ``<name>.new``, the old one renamed to ``<name>.old``, the new one
        renamed in, the old one removed.  :meth:`restore` falls back to
        ``<name>.old`` inside that window, so a preemption mid-save cannot
        restart training from epoch 0.

        A state split over a ``model`` axis raises: its tensors are this
        rank's slices, and a checkpoint holds whole tensors only.  Save
        ``parallel/mesh.gather_state(state)``, which every rank of the
        model group makes.
        """
        if split_convs(state.model):
            raise ValueError(
                f'checkpoint {name!r}: the state is split over a model axis;'
                f' save parallel/mesh.gather_state(state) (every rank of '
                f'the model group gathers) in its place')
        os.makedirs(self.directory, exist_ok=True)
        payload = {
            'model': state.model.state_dict(),
            'optimizer': (None if state.optimizer is None
                          else _plain_state_dict(state.optimizer)),
            'epoch': int(epoch),
        }
        path = self._path(name)
        tmp, old = path + '.new', path + '.old'
        with open(tmp, 'wb') as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        # a stale .old stays until the current file replaces it: after a
        # crash inside the window it is the only complete copy
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        if os.path.exists(old):
            os.remove(old)

    def restore(self, name: str, state: TrainState
                ) -> tuple[TrainState, int]:
        """Load into ``state`` (in place; tensors go to the model's device).
        Returns (state, next_epoch), or (state, 0) when the name is absent
        (reference load_model, main.py:185-195).  The optimizer state, and
        the step with it, is restored when ``state`` has an optimizer."""
        path = self._path(name)
        if not os.path.exists(path):
            if not os.path.exists(path + '.old'):
                return state, 0
            path = path + '.old'
        dev = next(state.model.parameters()).device
        payload = torch.load(path, map_location=dev, weights_only=True)
        state.model.load_state_dict(payload['model'])
        if state.optimizer is not None and payload['optimizer'] is not None:
            state.optimizer.load_state_dict(payload['optimizer'])
            state.step = _optimizer_step(state.optimizer)
        return state, int(payload['epoch']) + 1

    # The running best metrics persist in a sidecar, so a resumed run does
    # not restart its gates at +inf and overwrite the best aliases with
    # worse weights at its first eval.
    def _best_path(self) -> str:
        return os.path.join(self.directory, 'best_scores.json')

    def load_best(self) -> dict[str, float]:
        """The persisted running-best metrics ({} on a fresh run)."""
        try:
            with open(self._best_path()) as f:
                return {str(k): float(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            return {}

    def store_best(self, best: dict[str, float]) -> None:
        """Persist the running-best metrics atomically."""
        os.makedirs(self.directory, exist_ok=True)
        tmp = self._best_path() + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(best, f)
        os.replace(tmp, self._best_path())

    def save_rolling(self, state: TrainState, epoch: int,
                     score_tran: float | None = None,
                     score_rotate: float | None = None,
                     best: dict[str, float] | None = None,
                     save_last: bool = True) -> dict[str, float]:
        """'last' every epoch plus the metric-gated best aliases (reference
        main.py:408-417).  ``best`` carries the running minima (seed it with
        :meth:`load_best` on resume); returns the updated dict, which is
        also persisted.  ``save_last=False`` skips 'last' for a caller that
        saved it before a crash-prone eval."""
        best = dict(best or {})
        if save_last:
            self.save(LAST, state, epoch)
        # the sidecar goes first: a preemption between the two then leaves
        # a sidecar better than the weights on disk, which costs a missed
        # improvement; the other order lets a worse epoch replace a better
        # checkpoint
        if (score_tran is not None
                and score_tran < best.get(BEST_TRAN, float('inf'))):
            best[BEST_TRAN] = score_tran
            self.store_best(best)
            self.save(BEST_TRAN, state, epoch)
        if (score_rotate is not None
                and score_rotate < best.get(BEST_ROTATE, float('inf'))):
            best[BEST_ROTATE] = score_rotate
            self.store_best(best)
            self.save(BEST_ROTATE, state, epoch)
        return best
