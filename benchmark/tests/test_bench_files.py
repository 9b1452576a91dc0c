"""Every cell, configuration, traffic mix, driver and per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re

import pytest

from benchmark import run
from benchmark.lib.common import BENCH, ROOT, cell_metrics

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in SPEC['workloads']]


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['command'] == ['python3', 'benchmark/run.py']
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize('cell', CELLS)
def test_cell_loads_by_name(cell):
    spec = run.load_cell(cell)
    entry = next(w for w in SPEC['workloads'] if w['name'] == cell)
    assert spec['chips'] == entry['chips'] in (1, 4)
    assert spec['config']['name'] == entry['config']
    assert spec['why'] == entry['why'] and len(entry['why']) <= 200
    assert (BENCH / 'drivers' / ('%s.py' % spec['driver'])).is_file()
    assert (BENCH / 'traffic' / ('%s.json' % entry['traffic'])).is_file()
    assert 'setup_s' in cell_metrics(SPEC, cell, 0)
    assert len(cell_metrics(SPEC, cell, 0)) >= 2
    assert cell_metrics(SPEC, cell, 1)


@pytest.mark.parametrize('metric', [m['name'] for m in SPEC['per_layer']])
def test_metric_reader_loads_by_name(metric):
    module = run.load_module('metrics', metric)
    assert callable(module.read)
    assert module.read({'trace': None}) is None   # nothing to read


def test_names_units_and_moves():
    names = set()
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert m['name'] not in names
        names.add(m['name'])
    e2e = {m['name'] for m in SPEC['end_to_end']}
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        assert '\n' not in m['layer'] and len(m['layer']) <= 200
        for cell in m.get('workloads', []):
            assert m['moves'] in cell_metrics(SPEC, cell, 0)
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('entry', SPEC['configs'], ids=lambda c: c['name'])
def test_config_files(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert entry['file'] == 'benchmark/configs/%s.json' % entry['name']
    data = json.loads((ROOT / entry['file']).read_text())
    assert data['reduced'] == entry['reduced'] == []
    assert any(w['config'] == entry['name'] for w in SPEC['workloads'])
