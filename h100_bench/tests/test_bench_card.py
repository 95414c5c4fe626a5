"""The control of the check on the card (skips without one): the
reference one precision below the configuration's, in the program's
place, and for training each fault planted in the reference, must come
out not correct on every seed, and the program itself correct.  The
cells' own sizes, a short window each:

    python3 -m pytest h100_bench/tests/test_bench_card.py -q
"""

from types import SimpleNamespace

import pytest

from h100_bench import check, harness, run

SEEDS = (901, 902, 903)


def _judge(cell, numbers):
    return check.judge(numbers, harness.workload(cell)['limits'])


@pytest.mark.card
@pytest.mark.parametrize('cell', ['serve_online_b1', 'serve_offline_b256'])
def test_serving_control_fails(card, cell):
    from h100_bench.drivers.serve_closed import Serve
    for seed in SEEDS:
        s = Serve(run.make_context(cell, seed, 2.0, False, 'cuda'))
        s.setup()
        harness.Window(2.0).run(s.call)
        s.free_program()
        assert all(v['ok'] for v in _judge(cell, s.numbers()).values())
        control = _judge(cell, s.numbers(control=True))
        assert not all(v['ok'] for v in control.values()), control


def _fails(cell, numbers):
    """Whether a number fails its limit, among those the reading has (a
    fault of the window's judged call reads the window's numbers alone)."""
    limits = {k: v for k, v in harness.workload(cell)['limits'].items()
              if k in numbers}
    return not all(v['ok'] for v in check.judge(numbers, limits).values())


@pytest.mark.card
def test_training_control_and_faults_fail(card):
    from h100_bench.drivers import train_steps
    cell = 'train_b32'
    args = SimpleNamespace(workload=cell, seeds=SEEDS, control_seeds=SEEDS,
                           look_seeds=(), seconds=3.0)
    kinds = set()
    for seed, kind, numbers in train_steps.readings(
            args, harness.workload(cell)):
        kinds.add(kind)
        if kind == 'program':
            assert all(v['ok'] for v in _judge(cell, numbers).values()), \
                numbers
        else:
            assert _fails(cell, numbers), (seed, kind, numbers)
    assert kinds == {'program', 'control', 'fault_half_batch',
                     'fault_stale_batches', 'fault_state_unchanged'}
