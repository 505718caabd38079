"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card, plants one fault in the
port and drives the rest of a run of a tiny cell on the CPU, judged by the
limits of the cell named in the test.  The faults: a step that returns
its state unchanged; half of the batch left out (its rows take the other
half's results, or the mean is taken over the rest); a token altered where
it is produced (a sampled token, or a code of the frozen encode).  One
chip: there is no exchange between chips to leave out.  The control,
which needs the card at the cell's own size, is ``test_bench_control.py``.
"""

import time

import pytest
import torch
from conftest import add_tiny_cell

import harness
from paintmind_tpu_torch.models import pipeline as pl
from paintmind_tpu_torch.models import quantize as pq
from paintmind_tpu_torch.optim import optimizers as po

SOUND = pl.sample_step
SOUND_LOSS = pl.pipeline_loss
SOUND_QUANT = pq.Quantizer.forward


def unchanged(pipe, ids, **kw):
    return ids, ids


def half_batch(pipe, ids, **kw):
    b = ids.shape[0] // 2
    kw = dict(kw, context=kw['context'][:b])
    for k in ('temperature', 'guidance_scale'):
        if torch.is_tensor(kw.get(k)) and kw[k].ndim:
            kw[k] = kw[k][:b]
    nxt, pred = SOUND(pipe, ids[:b], **kw)
    return torch.cat([nxt, nxt]), torch.cat([pred, pred])


def altered(pipe, ids, **kw):
    nxt, pred = SOUND(pipe, ids, **kw)
    v = pipe.config.vqc.n_embed
    new = (ids == v) & (nxt != v)
    return torch.where(new, (nxt + 1) % v, nxt), pred


SAMPLING = {'unchanged': unchanged, 'half_batch': half_batch,
            'altered': altered}
CELLS = [('v1_t2i_b32', False, 't2i_b32'),
         ('moe_lb_t2i_b64', True, 't2i_b64'),
         ('v1_http_poisson', False, 'http_poisson')]


def _sound_then(cell, tmp_path, monkeypatch, plant):
    c = add_tiny_cell(str(tmp_path), 'fault_cell', moe=cell[1],
                      limits_from=cell[0], traffic=cell[2])
    sound, _ = harness.run_cell(c, 11, 1.0, 0, 'cpu', time.time())
    assert sound['correct'], sound['compared']
    plant(monkeypatch)
    try:
        res, _ = harness.run_cell(c, 11, 1.0, 0, 'cpu', time.time())
    except (IndexError, RuntimeError, ValueError):
        return          # the run fails: it prints no result
    assert not res['correct'], res['compared']


@pytest.mark.parametrize('cell', CELLS, ids=[c[0] for c in CELLS])
@pytest.mark.parametrize('fault', sorted(SAMPLING))
def test_sampling_fault_is_caught(tmp_path, monkeypatch, cell, fault):
    _sound_then(cell, tmp_path, monkeypatch,
                lambda mp: mp.setattr(pl, 'sample_step', SAMPLING[fault]))


def _no_update(self, closure=None):
    return None


def _half_loss(pipe, img, context, mask_ratio, **kw):
    b = img.shape[0] // 2
    return SOUND_LOSS(pipe, img[:b], None if context is None else context[:b],
                      mask_ratio, **kw)


def _altered_codes(self, z, beta=0.25, **kw):
    zq, loss, ids = SOUND_QUANT(self, z, beta, **kw)
    return zq, loss, (ids + 1) % self.codebook.shape[0]


TRAINING = {
    'unchanged': lambda mp: mp.setattr(po.Lion, 'step', _no_update),
    'half_batch': lambda mp: mp.setattr(pl, 'pipeline_loss', _half_loss),
    'altered': lambda mp: mp.setattr(pq.Quantizer, 'forward', _altered_codes),
}


@pytest.mark.parametrize('fault', sorted(TRAINING))
def test_training_fault_is_caught(tmp_path, monkeypatch, fault):
    _sound_then(('v1_train_b32', False, 'train_b32'), tmp_path, monkeypatch,
                TRAINING[fault])
