"""The held-out evaluation entry point of the port
(``cli/eval_synthetic.py``), on the CPU.

The port draws its frames with torch, so its frame set is not the JAX
one: the run on the r5 artifact is held to the JAX command's output keys
and to the score limit of the serving checks (median <= 0.01), and the
statistics to numpy recomputations of the JAX command's formulas
(``esa_pose_estimation_tpu/cli/eval_synthetic.py:200-231``) on given
per-frame scores, to the printed rounding.
"""

import numpy as np
import pytest
import torch

from esa_pose_estimation_tpu_torch.cli import eval_synthetic
from esa_pose_estimation_tpu_torch.models import layers


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARTIFACT = 'artifacts/esa_syn_r5.npz'
# the keys of the JAX command's JSON line (cli/eval_synthetic.py:221-231)
JAX_KEYS = {'frames', 'nonfinite_frames', 'median', 'p90', 'mean',
            'beat_reference_frac', 'worst', 'worst_depth_m', 'pix_err_px'}


def test_r5_on_cpu_scores_like_the_jax_command(capsys):
    rec = eval_synthetic.main(['--artifact', ARTIFACT, '--device', 'cpu',
                               '--frames', '8', '--batch-size', '4'])
    assert set(rec) == JAX_KEYS
    assert rec['frames'] == 8 and rec['nonfinite_frames'] == 0
    assert rec['median'] <= 0.01
    assert 0 < rec['pix_err_px'] < 3
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('# loaded artifact')
    assert lines[-1].startswith('{"frames": 8')


def test_int8_flag_is_served_and_restored(monkeypatch):
    monkeypatch.setattr(layers, 'INT8_SERVING', False)
    seen = []
    real = layers.int8_conv
    monkeypatch.setattr(layers, 'int8_conv',
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    rec = eval_synthetic.main(['--artifact', ARTIFACT, '--device', 'cpu',
                               '--frames', '3', '--batch-size', '2', '--int8'])
    assert seen == [1, 1]                  # the head conv, once per batch
    assert layers.INT8_SERVING is False
    assert rec['frames'] == 3 and rec['median'] <= 0.01


def _numpy_summary(scores, depths, pix_sum, pix_n):
    """The JAX command's statistics, written out in numpy."""
    finite = np.isfinite(scores)
    s, d = scores[finite], depths[finite]
    return {
        'frames': int(len(s)),
        'nonfinite_frames': int((~finite).sum()),
        'median': round(float(np.median(s)), 4),
        'p90': round(float(np.percentile(s, 90)), 4),
        'mean': round(float(s.mean()), 4),
        'beat_reference_frac': round(float((s < 0.0193).mean()), 3),
        'worst': round(float(s.max()), 3),
        'worst_depth_m': round(float(d[s.argmax()]), 1),
        'pix_err_px': round(pix_sum / max(pix_n, 1), 3),
    }


@pytest.mark.parametrize('bad', [[], [3], [0, 7]])
def test_summary_matches_the_jax_formulas(bad):
    rng = np.random.default_rng(len(bad))
    scores = rng.lognormal(-5.5, 0.8, size=40)
    depths = rng.uniform(5, 30, size=40)
    for i, j in enumerate(bad):
        scores[j] = (np.nan, np.inf)[i % 2]
    got = eval_synthetic.summarize(scores, depths, 41.3, 37)
    assert got == _numpy_summary(scores, depths, 41.3, 37)
    assert got['nonfinite_frames'] == len(bad)


def test_summary_of_no_finite_frame_is_null():
    got = eval_synthetic.summarize(np.array([np.nan, np.inf]),
                                   np.array([10.0, 20.0]), 0.0, 0)
    assert got['frames'] == 0 and got['nonfinite_frames'] == 2
    assert got['median'] is None and got['worst_depth_m'] is None
    assert got['pix_err_px'] == 0.0 and 'error' in got


@pytest.mark.parametrize('argv,exc,msg', [
    # no --artifact: the checkpoint route, and a run with no checkpoint
    pytest.param(['--workdir', '{tmp}'], FileNotFoundError,
                 r"'best_rotate' not found .*\(available: \[\]\)",
                 id='argv0-needs --artifact'),
    pytest.param(['--artifact', ARTIFACT, '--tiny'], SystemExit,
                 "flags select 'hrnet_tiny'",
                 id="argv1-flags select 'hrnet_tiny'"),
    pytest.param(['--artifact', ARTIFACT, '--crop-size', '96'], SystemExit,
                 'expects --crop-size', id='argv2-expects --crop-size'),
])
def test_refuses_what_it_cannot_evaluate(argv, exc, msg, tmp_path):
    argv = [a.format(tmp=str(tmp_path / 'run')) for a in argv]
    with pytest.raises(exc, match=msg):
        eval_synthetic.main(argv + ['--device', 'cpu'])
