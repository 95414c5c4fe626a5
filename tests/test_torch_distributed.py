"""Several processes in the port (``parallel/distributed.py``,
``parallel/mesh.wrap_data_parallel``, the global-batch statistics of
``models/layers.BatchNorm`` and the global-batch loss of
``distributed.global_mean``), on the CPU with gloo.

Two processes of batch 4 are held to one process of the same batch of 8,
three Adam steps of ``hrnet_tiny`` in f32: each process's loss (the mean
over the processes, which every process logs) and gradient norm within
relative 1e-6 of the one process's at the first step, 1e-5 at the later
ones; every running statistic within 1e-6 after the first step, 1e-5
after the third; the parameters within 2 lr after the first step and
steps x lr after the third; the two replicas bit-equal after every step,
though the processes start from different seeds (rank 0's parameters
are broadcast when the model is wrapped).  Adam's m/sqrt(v) saturates at
+-1 near zero gradients (ROADMAP section 3): a gradient element summed to
another sign moves its parameter up to 2 lr from the one process's, and
the later steps start from those parameters.  Each process also runs the
same steps from the same start through ``train/state.make_train_steps``
(the compiled program's route; on the CPU its steps run eagerly): its
losses and state ``torch.equal`` to ``train_step``'s.  The processes start
from the command line, so each is a fresh interpreter as under a launcher.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu.parallel import distributed as jdist
from esa_pose_estimation_tpu_torch.data import shards
from esa_pose_estimation_tpu_torch.parallel import distributed as tdist


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3

# One process's part: build hrnet_tiny from its rank's seed, take samples
# [lo, hi) of the saved batch, three train steps by train_step and three
# through make_train_steps from the same start, save what came out.
WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
    from esa_pose_estimation_tpu_torch.parallel import distributed as dist
    from esa_pose_estimation_tpu_torch.parallel.mesh import (
        wrap_data_parallel)
    from esa_pose_estimation_tpu_torch.train import state as tstate
    from esa_pose_estimation_tpu_torch.utils import config

    torch.set_num_threads(2)
    root, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if world > 1:
        torch.distributed.init_process_group(
            'gloo', init_method=f'file://{root}/rendezvous',
            world_size=world, rank=rank)

    def replica():
        # each rank from its own seed: the wrapper broadcasts rank 0's
        model = HRNet(config.hrnet_tiny()).init_weights(
            torch.Generator().manual_seed(rank))
        st = tstate.create_train_state(
            model, config.TrainConfig(lr_values=(1e-3, 1e-4, 1e-5, 1e-6)),
            100)
        if world > 1:
            st.train_model = wrap_data_parallel(model)
        return model, st
    data = np.load(f'{root}/batch.npz')
    n = data['image'].shape[0] // world
    batch = {k: torch.from_numpy(data[k][rank * n:(rank + 1) * n])
             for k in ('image', 'heatmaps', 'weights')}
    model, st = replica()
    out = {'loss': [], 'grad_norm': []}
    for step in range(%d):
        m = tstate.train_step(st, batch)
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
        if step == 0:
            first = {k: v.clone() for k, v in model.state_dict().items()}
    program, st = replica()
    steps = tstate.make_train_steps(st, tstate.heatmap_step_loss)
    out['program_loss'] = [float(steps([batch])[0]) for _ in range(%d)]
    out['group'] = dist.world_size()
    torch.save({'metrics': out, 'first': first, 'state': model.state_dict(),
                'program': program.state_dict()},
               f'{root}/out{world}_{rank}.pt')
    dist.shutdown()
''' % (STEPS, STEPS))


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _run_all(cmds, timeout=240):
    procs = [subprocess.Popen(c, cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.mark.parametrize('n,count', [(10, 3), (7, 2), (32, 4), (2, 3)])
def test_local_slice_matches_jax(n, count):
    recs = list(range(n))
    for pid in range(count):
        assert tdist.local_slice(recs, pid, count) == jdist.local_slice(
            recs, pid, count)
    with pytest.raises(ValueError):
        tdist.local_slice(recs, count, count)


def test_without_a_group_one_process(monkeypatch):
    assert tdist.initialize() is False
    assert tdist.requested_processes() == 1
    assert tdist.requested_processes(3) == 3
    monkeypatch.setenv('WORLD_SIZE', '4')
    assert tdist.requested_processes() == 4
    assert (tdist.rank(), tdist.world_size(), tdist.is_primary()) == (
        0, 1, True)
    assert tdist.global_batch_size(8) == 8
    assert tdist.local_slice(list(range(5))) == list(range(5))
    x = torch.tensor([1.5, -2.0])
    assert tdist.global_mean(x) is x
    tdist.barrier()
    tdist.shutdown()


def test_ddp_mode_rehearses_alone_on_the_cpu(tmp_path, one_thread):
    """``cli.mfu_experiments --ddp --device cpu --tiny`` in one process
    (no group: the mode's one-card reference): each program, the scan and
    the shard route's step, and the scan's second graph end bit-equal to
    their eager twins from the same start, with finite losses; the mode
    removes its shard after."""
    from esa_pose_estimation_tpu_torch.cli import mfu_experiments
    root = tmp_path / 'ddp'
    res = mfu_experiments.main(['--ddp', '--device', 'cpu', '--tiny',
                                '--workdir', str(root)])
    assert (res['processes'], res['device']) == (1, 'cpu')
    for key in ('scan_b2', 'shard_b2'):
        row = res[key]
        assert row['all_equal'] and row['finite'], row
        assert row['ranks'] == [[1, 1, 1, 1, 1]]
    assert res['scan_b2']['steps_per_graph'] == 4
    assert not root.exists()


def test_two_gloo_processes_match_one_process(tmp_path):
    from esa_pose_estimation_tpu_torch.data import synthetic
    b = synthetic.make_batch(torch.Generator().manual_seed(3), 8,
                             synthetic.spacecraft_points(n=6), crop_size=32)
    # standard-normal images, as the train parity tests use (ROADMAP
    # section 3: fast variance on flat crops)
    image = np.random.default_rng(4).normal(size=(8, 32, 32, 1))
    np.savez(tmp_path / 'batch.npz', image=image.astype(np.float32),
             heatmaps=b['heatmaps'].numpy(), weights=b['weights'].numpy())
    script = tmp_path / 'worker.py'
    script.write_text(WORKER)
    base = [sys.executable, str(script), str(tmp_path)]
    _run_all([base + ['0', '1'], base + ['0', '2'], base + ['1', '2']])
    one = torch.load(tmp_path / 'out1_0.pt', weights_only=True)
    two = [torch.load(tmp_path / f'out2_{r}.pt', weights_only=True)
           for r in range(2)]
    assert one['metrics']['group'] == 1
    assert two[0]['metrics']['group'] == two[1]['metrics']['group'] == 2
    for t in [one] + two:        # the program's route is train_step's
        assert t['metrics']['program_loss'] == t['metrics']['loss']
        for k, v in t['state'].items():
            assert torch.equal(v, t['program'][k]), k
    for when in ('first', 'state', 'program'):       # the replicas agree
        for k, v in two[0][when].items():
            assert torch.equal(v, two[1][when][k]), (when, k)
    rtol = [1e-6] + [1e-5] * (STEPS - 1)
    for step in range(STEPS):
        for t in two:        # each process logs the global batch's loss
            assert t['metrics']['loss'][step] == pytest.approx(
                one['metrics']['loss'][step], rel=rtol[step]), step
            assert t['metrics']['grad_norm'][step] == pytest.approx(
                one['metrics']['grad_norm'][step], rel=rtol[step]), step
    for when, stat_tol, param_tol in (('first', 1e-6, 2 * LR),
                                      ('state', 1e-5, STEPS * LR)):
        moved = 0
        for k, want in one[when].items():
            got = two[0][when][k]
            tol = stat_tol if 'running' in k else param_tol
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                                       rtol=0, err_msg=f'{when} {k}')
            moved += 'running' in k and not torch.equal(
                want, torch.zeros_like(want)) and not torch.equal(
                want, torch.ones_like(want))
        assert moved > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_only_the_primary_writes_the_run(tmp_path):
    """cli.train from a shard in two gloo processes: the steps go through
    ``make_train_steps`` (no eager route is named), the primary's logs and
    checkpoints are the workdir's, the secondary's go to proc1/, each
    process streams its half of the records, both log the same epoch loss
    (the global batch's), and the replicas end equal."""
    shard = str(tmp_path / 'train.spd')
    shards.write_synthetic_shard(shard, 16, height=240, width=384, n_kp=6,
                                 batch=8, device='cpu')
    wd = tmp_path / 'run'
    port = _free_port()
    cmd = [sys.executable, '-m', 'esa_pose_estimation_tpu_torch.cli.train',
           '--workdir', str(wd), '--tiny', '--epochs', '1', '--batch-size',
           '8', '--crop-size', '32', '--train-shard', shard, '--eval-every',
           '1', '--device', 'cpu', '--log-every', '1', '--coordinator',
           f'localhost:{port}', '--num-processes', '2', '--process-id']
    outs = _run_all([cmd + ['0'], cmd + ['1']])
    for out in outs:
        assert out.count('esa [1, ') == 2, out[-2000:]   # 16 / 8 steps
        assert ('training program: train/state.make_train_steps, steps on '
                'the CPU per call, 2 process(es)') in out, out[-2000:]
        assert not [ln for ln in out.splitlines() if 'eager' in ln]
    # each process draws its eval's panels into its own directory
    top = {p.name for p in wd.iterdir()}
    assert top == {'events.jsonl', 'log_esa.txt', 'net_esa', 'panels',
                   'proc1'}
    assert {p.name for p in (wd / 'proc1').iterdir()} == {
        'events.jsonl', 'log_esa.txt', 'net_esa', 'panels'}
    a = torch.load(wd / 'net_esa' / 'last', weights_only=True)['model']
    b = torch.load(wd / 'proc1' / 'net_esa' / 'last',
                   weights_only=True)['model']
    assert all(torch.equal(a[k], b[k]) for k in a)
    rows = [(wd / d / 'log_esa.txt').read_text().splitlines()
            for d in ('.', 'proc1')]
    assert rows[0][0].split('\t') == ['Epoch', 'LR', 'Train Loss']
    assert len(rows[0]) == 2 and rows[0] == rows[1], rows
    with open(wd / 'events.jsonl') as f:
        events = [json.loads(line)['event'] for line in f]
    assert 'eval' in events


def test_batch_must_divide_over_the_processes(tmp_path):
    """Each process refuses the batch before it joins the group, so none
    waits for a process that has left."""
    port = _free_port()
    cmd = [sys.executable, '-m', 'esa_pose_estimation_tpu_torch.cli.train',
           '--workdir', str(tmp_path / 'r'), '--tiny', '--epochs', '1',
           '--batch-size', '5', '--crop-size', '32', '--synthetic-size',
           '10', '--device', 'cpu', '--coordinator', f'localhost:{port}',
           '--num-processes', '2', '--process-id']
    procs = [subprocess.Popen(cmd + [str(i)], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode != 0
        assert 'must divide over 2 processes' in out, out[-2000:]
