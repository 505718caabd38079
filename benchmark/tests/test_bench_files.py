"""Every cell and metric of BENCHMARK.json resolves to its files by name,
and a cell, a configuration, a traffic mix and a per-layer metric added as
files alone are found."""

import json
import os

import harness
import pytest
from conftest import BENCH, ROOT, add_tiny_cell

with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    BENCHMARK = json.load(f)


@pytest.mark.parametrize('cell', [w['name'] for w in BENCHMARK['workloads']])
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    assert os.path.exists(os.path.join(BENCH, 'generators',
                                       c.traffic['generator'] + '.py'))
    assert c.config['name'] == c.workload['config']
    assert c.end_to_end() and c.per_layer()
    names = {m['name'] for m in c.end_to_end()}
    assert 'setup_s' in names and len(names) >= 2
    for m in c.per_layer():
        assert m['moves'] in names


@pytest.mark.parametrize('metric', [m['name'] for m in BENCHMARK['per_layer']])
def test_metric_reader_exists(metric):
    mod = harness.import_file(
        os.path.join(BENCH, 'layer_metrics', metric + '.py'), 'm')
    assert callable(mod.read)


def test_configs_name_their_files():
    for c in BENCHMARK['configs']:
        with open(os.path.join(ROOT, c['file'])) as f:
            conf = json.load(f)
        assert conf['name'] == c['name']
        assert conf['reduced'] == c['reduced']


def test_new_cell_and_metric_as_files(tmp_path):
    cell = add_tiny_cell(str(tmp_path), 'throwaway_cell')
    assert cell.config['name'] == 'tiny'
    assert cell.traffic['batch'] == 4
    # a per-layer metric: a reader file and an entry
    base = os.path.join(str(tmp_path), 'benchmark')
    with open(os.path.join(base, 'layer_metrics', 'calls.batch.py'), 'w') as f:
        f.write('def read(ctx):\n    return float(ctx.counters["calls"])\n')
    path = os.path.join(str(tmp_path), 'BENCHMARK.json')
    with open(path) as f:
        bench = json.load(f)
    bench['per_layer'].append({
        'name': 'calls.batch', 'unit': 'calls', 'better': 'higher',
        'source': 'program_counter', 'layer': 'a test',
        'moves': 'images_per_s', 'workloads': ['throwaway_cell']})
    with open(path, 'w') as f:
        json.dump(bench, f)
    cell = harness.resolve('throwaway_cell', root=str(tmp_path), base=base)
    assert 'calls.batch' in {m['name'] for m in cell.per_layer()}
    out = harness.layer_metrics(cell, {'window': 1.0, 'busy_s': 0.0,
                                       'kernels': {}, 'ranges': {}},
                                {'calls': 3}, {'platform': 'cpu'})
    assert out['calls.batch']['value'] == 3.0
