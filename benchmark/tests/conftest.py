"""Tests of the benchmark itself: ``python -m pytest benchmark/tests -q``
from the root of the repository (CPU; the ``card`` tests run on a CUDA
device only and skip elsewhere)."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA device')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def tiny_config(name, moe=False):
    """A configuration file of ``name`` at a size the CPU runs in seconds."""
    src = 'paintmindv1-moe.json' if moe else 'paintmindv1.json'
    with open(os.path.join(BENCH, 'configs', src)) as f:
        c = json.load(f)
    for k in ('enc', 'dec'):
        c['stage1'][k].update(image_size=32, dim=32, depth=2, num_head=2,
                              dim_head=16, mlp_dim=64)
    c['stage1'].update(n_embed=64, embed_dim=8)
    c['pipeline'].update(dim=32, depth=2, num_head=2, dim_head=16, mlp_dim=64)
    if moe:
        c['pipeline'].update(num_experts=4)
    c['name'] = name
    # fp32 at this size: the sound run then reads far inside the cells'
    # limits, which were set at the cells' own size in bf16
    c['compute_dtype'] = 'float32'
    return c


TINY_TRAFFIC = {
    't2i_b32': dict(batch=4, timesteps=4, context_len=5),
    't2i_b64': dict(batch=4, timesteps=4, context_len=5),
    'http_poisson': dict(rate=6.0, timesteps=4, max_batch=4, grace=30),
    'train_b32': dict(batch=4, corpus=16, context_len=5),
}
TINY_TRAINER = {
    'train_b32': dict(mixed_precision='no'),
}


def add_tiny_cell(root, cell, moe=False, limits_from='v1_t2i_b32',
                  traffic='t2i_b32'):
    """Add a tiny cell of ``traffic`` to the benchmark copied under
    ``root``, as files and BENCHMARK.json entries alone, checked by the
    limits of the cell ``limits_from``; returns the harness's Cell."""
    import harness
    base = os.path.join(root, 'benchmark')
    if not os.path.exists(base):
        shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
            '__pycache__', '.cache', 'tests'))
        shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    conf = 'tiny-moe' if moe else 'tiny'
    tc = tiny_config(conf, moe)
    if 'tower' in tc:
        tc['tower'].update(num_layers=1, d_ff=64, num_heads=2, d_kv=16)
    with open(os.path.join(base, 'configs', conf + '.json'), 'w') as f:
        json.dump(tc, f)
    with open(os.path.join(base, 'traffic', traffic + '.json')) as f:
        tr = json.load(f)
    tr.update(TINY_TRAFFIC[traffic])
    if traffic in TINY_TRAINER:
        tr['trainer'] = dict(tr['trainer'], **TINY_TRAINER[traffic])
    for m in tr.get('mix', ()):
        m['timesteps'] = tr['timesteps']
        m['topk'] = min(m['topk'], 6)
    with open(os.path.join(base, 'traffic', 'tiny_' + traffic + '.json'), 'w') as f:
        json.dump(tr, f)
    with open(os.path.join(base, 'cells', limits_from + '.json')) as f:
        check = json.load(f)
    with open(os.path.join(base, 'cells', cell + '.json'), 'w') as f:
        json.dump(check, f)
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as f:
        bench = json.load(f)
    if conf not in {c['name'] for c in bench['configs']}:
        bench['configs'].append({'name': conf, 'source': 'a test',
                                 'file': f'benchmark/configs/{conf}.json',
                                 'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': cell, 'config': conf,
                               'traffic': 'tiny_' + traffic, 'chips': 1,
                               'why': 'a test'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if limits_from in m.get('workloads', ()):
            m['workloads'].append(cell)
    with open(path, 'w') as f:
        json.dump(bench, f)
    return harness.resolve(cell, root=root, base=base)
