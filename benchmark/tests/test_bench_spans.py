"""The per-layer readers of the program's own spans and counters
(``spans.py``, ``layer_metrics/{moe_expert_ms_per_step,
moe_move_ms_per_step,moe_fill,sampler_ms_per_step}.batch.py``,
``layer_metrics/{encode,optim}_ms_per_update.train.py``) against
snapshots built by hand, the cases that read nothing included; on a card,
tiny traced cells read every one."""

import os
import time

import pytest
from conftest import BENCH, add_tiny_cell

import harness
import spans

GPU = {'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3'}
BATCH = ('moe_expert_ms_per_step.batch', 'moe_move_ms_per_step.batch',
         'moe_fill.batch', 'sampler_ms_per_step.batch')
TRAIN = ('encode_ms_per_update.train', 'optim_ms_per_update.train')


def _reader(name):
    return harness.import_file(os.path.join(BENCH, 'layer_metrics',
                                            name + '.py'),
                               'spans_' + name.replace('.', '_'))


def _span(count, device_s):
    return {'count': count, 'host_s': 1.0, 'host_self_s': 0.5,
            'device_s': device_s, 'device_self_s': device_s}


def _moe_snap(routed=2 * 16 * 2 * 12):
    return {'spans': {'pm.moe': _span(routed, 4.8),
                      'pm.moe.experts': _span(routed, 2.4),
                      'pm.step.draw': _span(32, 0.032),
                      'pm.step.remask': _span(32, 0.016)},
            'counters': {'pm.moe.kept': 46.0, 'pm.moe.assignments': 100.0}}


def _train_snap(updates=10):
    return {'spans': {'pm.train.update': _span(updates, 2.0),
                      'pm.train.encode': _span(10, 0.07),
                      'pm.train.optimizer': _span(updates, 0.12)},
            'counters': {}}


def _ctx(cell, counters, device=GPU):
    return harness.ReaderContext(cell=harness.resolve(cell), trace={},
                                 counters=counters, device=device)


BATCH_COUNTERS = {'calls': 2, 'guided': True, 'launches': {}}
TRAIN_COUNTERS = {'steps': 10, 'dropped': 1, 'launches': {}}


def test_batch_readers(monkeypatch):
    monkeypatch.setattr(spans, 'snapshot', _moe_snap)
    ctx = _ctx('moe_lb_t2i_b64', BATCH_COUNTERS)
    want = {'moe_expert_ms_per_step.batch': 75.0,      # 2.4 s / 32 steps
            'moe_move_ms_per_step.batch': 75.0,        # (4.8 - 2.4) / 32
            'moe_fill.batch': 46.0,
            'sampler_ms_per_step.batch': 1.5}          # 48 ms / 32 steps
    for name, value in want.items():
        assert _reader(name).read(ctx) == pytest.approx(value), name


def test_train_readers(monkeypatch):
    monkeypatch.setattr(spans, 'snapshot', _train_snap)
    ctx = _ctx('v1_train_b32', TRAIN_COUNTERS)
    assert _reader('encode_ms_per_update.train').read(ctx) == \
        pytest.approx(7.0)
    assert _reader('optim_ms_per_update.train').read(ctx) == \
        pytest.approx(12.0)


@pytest.mark.parametrize('case', ['cpu', 'missing', 'count', 'no_program',
                                  'no_calls'])
def test_batch_readers_read_nothing(monkeypatch, case):
    snap = _moe_snap(routed=767 if case == 'count' else 768)
    if case == 'missing':
        del snap['spans']['pm.moe.experts'], snap['spans']['pm.step.remask']
        del snap['spans']['pm.moe']
    monkeypatch.setattr(spans, 'snapshot', lambda: snap)
    if case == 'no_program':       # a checkout before the program's spans
        from paintmind_tpu_torch.utils import profiling
        monkeypatch.undo()
        monkeypatch.delattr(profiling, 'snapshot')
    counters = dict(BATCH_COUNTERS, calls=0 if case == 'no_calls' else 2)
    ctx = _ctx('moe_lb_t2i_b64', counters,
               {'platform': 'cpu', 'kind': 'cpu'} if case == 'cpu' else GPU)
    read = {n: _reader(n).read(ctx) for n in BATCH}
    if case == 'count':            # the sampler's own spans still agree
        assert read.pop('sampler_ms_per_step.batch') == pytest.approx(1.5)
    assert all(v is None for v in read.values()), read


def test_dense_cell_reads_no_routed_layer(monkeypatch):
    monkeypatch.setattr(spans, 'snapshot', _moe_snap)
    ctx = _ctx('v1_t2i_b32', BATCH_COUNTERS)
    assert _reader('moe_fill.batch').read(ctx) is None
    assert _reader('sampler_ms_per_step.batch').read(ctx) == \
        pytest.approx(1.5)


@pytest.mark.parametrize('case', ['cpu', 'count', 'no_program'])
def test_train_readers_read_nothing(monkeypatch, case):
    snap = _train_snap(updates=9 if case == 'count' else 10)
    monkeypatch.setattr(spans, 'snapshot', lambda: snap)
    if case == 'no_program':
        from paintmind_tpu_torch.utils import profiling
        monkeypatch.undo()
        monkeypatch.delattr(profiling, 'snapshot')
    ctx = _ctx('v1_train_b32', TRAIN_COUNTERS,
               {'platform': 'cpu', 'kind': 'cpu'} if case == 'cpu' else GPU)
    assert all(_reader(n).read(ctx) is None for n in TRAIN)


def test_a_traced_cpu_run_reads_none_and_raises_nothing(tmp_path):
    from paintmind_tpu_torch.utils import profiling
    profiling.reset()
    cell = add_tiny_cell(str(tmp_path), 'spans_cpu_cell', moe=True,
                         limits_from='moe_lb_t2i_b64')
    res, _ = harness.run_cell(cell, 2 ** 31 + 17, 0.2, 1, 'cpu', time.time())
    assert not set(BATCH) & set(res['metrics'])
    # the program recorded the window's spans all the same
    snap = profiling.snapshot()
    calls = res['diagnostics']['counters']['calls']
    steps = calls * cell.traffic['timesteps']
    assert snap['spans']['pm.step.draw']['count'] == steps
    assert snap['spans']['pm.moe.experts']['count'] == \
        steps * 2 * cell.config['pipeline']['depth']
    profiling.reset()


CARD_CELLS = [('spans_dense', False, 'v1_t2i_b32', 't2i_b32'),
              ('spans_moe', True, 'moe_lb_t2i_b64', 't2i_b64'),
              ('spans_train', False, 'v1_train_b32', 'train_b32')]


@pytest.mark.card
@pytest.mark.parametrize('name,moe,like,traffic', CARD_CELLS)
def test_tiny_traced_cell_reads_every_new_metric(card, tmp_path, name, moe,
                                                 like, traffic):
    from paintmind_tpu_torch.utils import profiling
    profiling.reset()
    cell = add_tiny_cell(str(tmp_path), name, moe=moe, limits_from=like,
                         traffic=traffic)
    res, _ = harness.run_cell(cell, 2 ** 33 + 5, 2, 1, 'cuda', time.time())
    mine = {m['name'] for m in cell.per_layer()} & set(BATCH + TRAIN)
    assert mine and mine <= set(res['metrics']), res['metrics']
    profiling.reset()
