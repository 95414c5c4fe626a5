"""BENCHMARK.json and the files the harness finds by name."""

import json
import re

import pytest

from h100_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


@pytest.mark.parametrize('name', [m['name'] for m in METRICS]
                         + [w['name'] for w in BENCH['workloads']]
                         + [c['name'] for c in BENCH['configs']]
                         + [w['traffic'] for w in BENCH['workloads']])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_units_and_keys(metric):
    assert UNIT.match(metric['unit']), metric['unit']
    assert metric['better'] in ('lower', 'higher')
    keys = {'name', 'unit', 'better', 'source', 'workloads'}
    if metric in BENCH['end_to_end']:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert set(metric) <= keys | {'bound'}
        assert 0.01 <= metric['bound'] <= 0.25
    else:
        assert set(metric) <= keys | {'layer', 'moves'}


def test_unique_and_counts():
    for group in (METRICS, BENCH['workloads'], BENCH['configs']):
        names = [x['name'] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH['workloads'] if w['chips'] == 4]
    assert len(four) <= max(1, len(BENCH['workloads']) // 4)
    assert 'setup_s' in [m['name'] for m in BENCH['end_to_end']]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_files(cell):
    wl = harness.workload(cell['name'])
    assert wl['config'] == cell['config'] and wl['chips'] == cell['chips']
    assert (harness.HERE / 'drivers' / f'{wl["driver"]}.py').exists()
    cfg = harness.config(wl['config'])
    assert cfg['name'] == cell['config']
    e2e, per_layer = harness.metrics_of(BENCH, cell['name'])
    names = sorted(m['name'] for m in e2e)
    assert names == sorted(wl['end_to_end']), names
    assert 'setup_s' in names and len(names) >= 2 and per_layer


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_config_files(config):
    path = harness.ROOT / config['file']
    assert path.exists()
    assert config['file'].startswith(tuple(p + '/' for p in BENCH['paths']))
    assert harness.config(config['name'])['reduced'] == config['reduced']


@pytest.mark.parametrize('metric', BENCH['per_layer'], ids=lambda m: m['name'])
def test_per_layer_reported_where_listed(metric):
    """Each per-layer metric has its reader, and each of its cells
    reports the end-to-end metric it moves."""
    assert callable(harness.reader(metric['name']))
    for cell in metric['workloads']:
        e2e, per_layer = harness.metrics_of(BENCH, cell)
        assert metric['moves'] in [m['name'] for m in e2e], cell
        assert metric in per_layer


def test_limits_set():
    for cell in BENCH['workloads']:
        limits = harness.workload(cell['name'])['limits']
        assert limits and all(v is not None and v >= 0
                              for v in limits.values()), cell['name']
