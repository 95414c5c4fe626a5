"""The reference and the port agree at ``hrnet_tiny`` size on the CPU,
through the harness's own run of each cell (the look for a card
skipped); and with the timed path broken underneath, ``correct`` comes
out false, once for each fault the cell can have."""

import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from h100_bench import harness, run
from h100_bench.tests import _tiny

SERVE = ['serve_offline_b256', 'serve_online_b1']


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    return _tiny.artifact(str(tmp_path_factory.mktemp('w') / 'tiny.npz'))


@pytest.mark.parametrize('cell', SERVE + ['train_b32'])
def test_sound_run_is_correct(cell, weights):
    out = run.run_cell(_tiny.context(cell, weights))
    assert out['correct'], out['judged']
    assert out['attempted'] > 0 and out['failed'] == 0
    assert set(out['metrics']) == set(harness.workload(cell)['end_to_end'])


def _altered(field):
    """``infer_poses`` whose answer is altered where it is produced."""
    from esa_pose_estimation_tpu_torch import pipeline
    plain = pipeline.infer_poses

    @functools.wraps(plain)
    def infer(*args, **kwargs):
        out = plain(*args, **kwargs)
        v = getattr(out, field)
        if field == 'R':
            c, s = torch.cos(torch.tensor(1e-3)), torch.sin(torch.tensor(1e-3))
            rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            v = v @ rot
        else:
            v = v.clone()
            v[0].view(-1)[0] += {'heatmaps': 0.05, 'keypoints_2d': 0.5,
                                 'confidences': 0.01,
                                 'trans': 0.05}[field]
        return out._replace(**{field: v})
    return infer


@pytest.mark.parametrize('field', ['heatmaps', 'keypoints_2d', 'confidences',
                                   'R', 'trans'])
def test_altered_answer_fails(field, weights, monkeypatch):
    from esa_pose_estimation_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, 'infer_poses', _altered(field))
    out = run.run_cell(_tiny.context('serve_online_b1', weights))
    assert not out['correct'], out['judged']


@pytest.mark.parametrize('field', ['keypoints_2d', 'trans'])
def test_altered_answer_sent_ahead_fails(field, weights, monkeypatch):
    """The same through the offline cell's calls sent ahead."""
    from esa_pose_estimation_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, 'infer_poses', _altered(field))
    ctx = _tiny.context('serve_offline_b256', weights)
    assert ctx.workload['traffic']['ahead_calls'] > 0
    out = run.run_cell(ctx)
    assert not out['correct'], out['judged']


def test_unchanged_state_fails(weights, monkeypatch):
    """A call whose steps return the state as it was."""
    from esa_pose_estimation_tpu_torch.train import state as tstate
    plain = tstate.make_train_steps

    def make(state, loss_fn, n_inner=1):
        fn = plain(state, loss_fn, n_inner)

        def steps(inputs):
            keep = [t.detach().clone() for t in state.model.parameters()]
            losses = fn(inputs)
            with torch.no_grad():
                for p, k in zip(state.model.parameters(), keep):
                    p.copy_(k)
            return losses
        return steps
    monkeypatch.setattr(tstate, 'make_train_steps', make)
    out = run.run_cell(_tiny.context('train_b32', weights))
    assert not out['correct'] and not out['judged']['update_gap']['ok']


def test_stale_batches_fail(weights, monkeypatch):
    """Calls after the first that train on the first call's batches again,
    as static input buffers left stale would: only the window's check
    sees it."""
    from esa_pose_estimation_tpu_torch.train import state as tstate
    plain = tstate.make_train_steps

    def make(state, loss_fn, n_inner=1):
        fn = plain(state, loss_fn, n_inner)
        first = []

        def steps(inputs):
            first.append(first[0] if first else inputs)
            return fn(first[0])
        return steps
    monkeypatch.setattr(tstate, 'make_train_steps', make)
    out = run.run_cell(_tiny.context('train_b32', weights))
    assert not out['correct']
    assert out['judged']['loss_gap']['ok'], out['judged']
    assert not out['judged']['window_loss_gap']['ok'], out['judged']


def test_half_batch_fails(weights, monkeypatch):
    """Half of each batch left out, the loss the mean over the rest."""
    from esa_pose_estimation_tpu_torch.train import state as tstate
    plain = tstate.heatmap_step_loss

    def half(model, batch, loss_w=10.0):
        n = batch['image'].shape[0] // 2
        return plain(model, {k: v[:n] for k, v in batch.items()}, loss_w)
    monkeypatch.setattr(tstate, 'heatmap_step_loss', half)
    out = run.run_cell(_tiny.context('train_b32', weights))
    assert not out['correct'], out['judged']


def _two_ranks(weights, tmp_path, no_exchange: bool) -> dict:
    port = run._free_port()
    out = tmp_path / f'out_{int(no_exchange)}.json'
    code = ('import sys; from h100_bench.tests import _tiny; '
            '_tiny.child(*sys.argv[1:3], int(sys.argv[3]), int(sys.argv[4]), '
            'int(sys.argv[5]), sys.argv[6], sys.argv[7] == "1")')
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, 'train_ddp4_b32', weights, '2', str(r),
         str(port), str(out), str(int(no_exchange))],
        cwd=str(harness.ROOT), env={**os.environ,
                                    'OMP_NUM_THREADS': '1'})
        for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    return json.loads(out.read_text())


def test_ranks_agree_and_exchange_left_out_fails(weights, tmp_path):
    """Two gloo processes of the several-card cell: correct as they are,
    not correct with the exchange between them left out."""
    assert _two_ranks(weights, tmp_path, False)['correct']
    assert not _two_ranks(weights, tmp_path, True)['correct']
