"""The port's spans and counters (``paintmind_tpu_torch/utils/profiling.py``)
on the CPU: off they cost a check and record nothing; on they keep the
profiler trace's clock, their parents and ids, host self times, and fold
into the totals ``snapshot()`` gives; laid through the sampler loop, the
routed FFN, the stage-2 train step and the serving engine and server they
count what the tiny pipelines run.  ``GenerationEngine.stats()`` latency:
from ``submit``, nearest rank."""

import http.client
import json
import threading
import time

import pytest
import torch

import paintmind_tpu_torch as pt
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.nn.core import LayerNorm
from paintmind_tpu_torch.serving import (GenerateRequest, GenerationEngine,
                                         make_server)
from paintmind_tpu_torch.serving.engine import _nearest_rank
from paintmind_tpu_torch.train import steps as tsteps
from paintmind_tpu_torch.utils import profiling

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

TINY_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
tcfg.register_version('torch-trace-vqgan', TINY_VQ)
PIPE_KW = dict(stage1='torch-trace-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, t5_dim=48, dropout=0.0)
DEPTH = {'dense': 1, 'moe': 2}
STEPS = 3


def _pipe(kind):
    extra = dict(num_experts=4, num_selected=2, capacity_factor=1.0) \
        if kind == 'moe' else {}
    cfg = tpl.PipelineConfig(vqc=tpl.vm.VQModelConfig.from_dict(TINY_VQ),
                             depth=DEPTH[kind], **PIPE_KW, **extra)
    torch.manual_seed(0)
    return tpl.Pipeline(cfg, stage1_pretrained=False, text_encoder=None,
                        device='cpu')


@pytest.fixture(scope='module')
def dense():
    return _pipe('dense')


@pytest.fixture(autouse=True)
def _clean():
    assert not profiling.enabled()
    profiling.reset()
    yield
    profiling.reset()


def _context(b, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, 5, 48, generator=g)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r['name'], []).append(r)
    return out


def test_off_records_nothing(monkeypatch, dense):
    made = []
    real = profiling.record_function

    def counting(*a, **kw):
        made.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(profiling, 'record_function', counting)
    first = profiling.annotate('a')
    assert profiling.annotate('b', id=3) is first
    with profiling.annotate('pm.x', batch=2):
        with profiling.annotate('pm.x.y'):
            pass
    profiling.count('pm.c', torch.ones(3))
    profiling.record('pm.r', 0, 10)
    dense.generate(text=_context(2), timesteps=2, guidance_scale=3.0,
                   decode_steps='final')
    assert made == []
    assert profiling.snapshot() == {'spans': {}, 'counters': {}}
    assert profiling.records() == []


def test_decorator_gates_every_call():
    @profiling.annotate('pm.decorated', id=7)
    def work(x):
        return x + 1

    assert work(1) == 2
    with profiling.recording():
        assert work(2) == 3
    assert work(3) == 4
    snap = profiling.snapshot()
    assert snap['spans']['pm.decorated']['count'] == 1
    assert profiling.records()[-1]['attrs'] == {'id': 7}


def test_span_and_trace_share_the_clock(tmp_path):
    with profiling.trace(None, activities=('cpu',)) as prof:
        assert profiling.enabled()
        with profiling.annotate('pm.clock', id=11):
            torch.ones(64, 64).sum()
    path = str(tmp_path / 't.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace['baseTimeNanoseconds'] / 1000
    ev = [e for e in trace['traceEvents'] if e.get('name') == 'pm.clock'
          and e.get('cat') == 'user_annotation']
    assert len(ev) == 1
    rec = profiling.records()[-1]
    assert rec['name'] == 'pm.clock' and rec['attrs']['id'] == 11
    assert abs(float(ev[0]['ts']) + base - rec['start_ns'] / 1000) < 1000
    span = profiling.snapshot()['spans']['pm.clock']
    assert span['count'] == 1 and span['device_s'] is None


def test_nested_self_times_and_ids():
    with profiling.recording():
        with profiling.annotate('pm.outer'):
            time.sleep(0.02)
            with profiling.annotate('pm.inner'):
                time.sleep(0.03)
            with profiling.annotate('pm.inner'):
                time.sleep(0.01)
        profiling.record('pm.gap', 10, 10 + 5_000_000, id=99)
        profiling.count('pm.kept', torch.tensor([True, False, True]))
        profiling.count('pm.kept', 4)
    snap = profiling.snapshot()
    outer, inner = snap['spans']['pm.outer'], snap['spans']['pm.inner']
    assert inner['count'] == 2 and outer['count'] == 1
    assert inner['host_self_s'] == pytest.approx(inner['host_s'])
    assert outer['host_self_s'] == pytest.approx(
        outer['host_s'] - inner['host_s'], abs=1e-9)
    assert outer['host_self_s'] >= 0.02 and inner['host_s'] >= 0.04
    assert snap['spans']['pm.gap']['host_s'] == pytest.approx(5e-3)
    assert snap['counters'] == {'pm.kept': 6.0}
    recs = _by_name(profiling.records())
    (o,) = recs['pm.outer']
    assert all(r['parent'] == 'pm.outer' and r['attrs']['id'] ==
               o['attrs']['id'] for r in recs['pm.inner'])
    assert recs['pm.gap'][0]['parent'] is None
    profiling.reset()
    assert profiling.snapshot() == {'spans': {}, 'counters': {}}


def test_recording_covers_every_thread():
    def work():
        with profiling.annotate('pm.thread'):
            pass

    with profiling.recording():
        t = threading.Thread(target=work)
        t.start()
        t.join(30)
    assert not t.is_alive()
    assert profiling.snapshot()['spans']['pm.thread']['count'] == 1


@pytest.mark.parametrize('kind', ['dense', 'moe'])
def test_generate_spans(kind, dense):
    pipe = dense if kind == 'dense' else _pipe('moe')
    with profiling.recording():
        pipe.generate(text=_context(2), timesteps=STEPS, guidance_scale=3.0,
                      decode_steps='final')
    snap = profiling.snapshot()
    spans = snap['spans']
    assert spans['pm.generate']['count'] == 1
    assert spans['pm.decode']['count'] == 1
    for part in ('logits', 'draw', 'remask'):
        assert spans['pm.step.' + part]['count'] == STEPS
    moe = ['pm.moe'] + ['pm.moe.' + p for p in
                        ('route', 'dispatch', 'experts', 'combine', 'aux')]
    if kind == 'dense':
        assert not set(moe) & set(spans)
        # no routed layer: the attention's and the norms' counters alone
        assert set(snap['counters']) == {'pm.attn.ops', 'pm.attn.kv_bytes',
                                          'pm.norm.one_pass'}
        assert snap['counters']['pm.attn.ops'] > 0
        # parameters in the activations' type: every LayerNorm one pass,
        # 3 a block and the final norm a step (at B <= 8 one pass over the
        # [cond; uncond] rows), then the decoder's
        decoder = sum(isinstance(m, LayerNorm)
                      for m in pipe.vqgan.decoder.modules())
        assert snap['counters']['pm.norm.one_pass'] == \
            STEPS * (3 * DEPTH['dense'] + 1) + decoder
    else:
        calls = 2 * DEPTH['moe'] * STEPS        # guided: two passes a step
        assert all(spans[n]['count'] == calls for n in moe)
        c = snap['counters']
        assert c['pm.moe.assignments'] == calls * 2 * pipe.num_tokens * 2
        assert 0 < c['pm.moe.kept'] <= c['pm.moe.assignments']
    recs = _by_name(profiling.records())
    (gen,) = recs['pm.generate']
    assert gen['attrs']['batch'] == 2 and gen['attrs']['steps'] == STEPS
    for name, rs in recs.items():
        assert all(r['attrs']['id'] == gen['attrs']['id'] for r in rs), name
    assert all(r['parent'] == 'pm.generate' for r in recs['pm.step.draw'])
    assert all(r['parent'] == 'pm.step.logits' for r in
               recs.get('pm.moe', ()))


def test_train_step_spans(dense):
    pipe = _pipe('dense')
    opt = pt.optim.lion(pipe.trainable_parameters(), 1e-4, (0.9, 0.99),
                        max_grad_norm=1.0)
    step = tsteps.make_pipeline_train_step(pipe, opt)
    img = torch.rand(2, 32, 32, 3) * 2 - 1
    with profiling.recording():
        step(img, _context(2), 0.5)
    spans = profiling.snapshot()['spans']
    phases = ('encode', 'forward', 'backward', 'optimizer')
    assert spans['pm.train.update']['count'] == 1
    assert all(spans['pm.train.' + p]['count'] == 1 for p in phases)
    recs = _by_name(profiling.records())
    assert all(recs['pm.train.' + p][0]['parent'] == 'pm.train.update'
               for p in phases)
    upd = spans['pm.train.update']
    assert upd['host_self_s'] == pytest.approx(
        upd['host_s'] - sum(spans['pm.train.' + p]['host_s']
                            for p in phases), abs=1e-9)


def test_serving_spans_carry_request_ids(dense):
    ctx = _context(2).numpy()
    with profiling.recording(), \
            GenerationEngine(dense, max_batch=4, max_wait_ms=500) as eng:
        srv = make_server(eng, port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            futs = [eng.submit(GenerateRequest(context=ctx[i], timesteps=1))
                    for i in range(2)]
            for f in futs:
                f.result(timeout=120)
            conn = http.client.HTTPConnection('127.0.0.1',
                                              srv.server_address[1],
                                              timeout=120)
            conn.request('POST', '/generate', json.dumps(
                {'context': ctx[0].tolist(), 'timesteps': 1}))
            assert conn.getresponse().status == 200
        finally:
            srv.shutdown()
            srv.server_close()
    recs = _by_name(profiling.records())
    ids = [f.request_id for f in futs]
    batch = recs['pm.serve.batch'][0]
    assert batch['attrs']['requests'] == ids
    assert batch['attrs']['padded'] == 0
    queued = [r for r in recs['pm.serve.queue'] if r['attrs']['id'] in ids]
    assert sorted(r['attrs']['id'] for r in queued) == sorted(ids)
    assert all(r['attrs']['batch'] == batch['attrs']['id'] for r in queued)
    first_gen = recs['pm.generate'][0]
    assert first_gen['parent'] == 'pm.serve.batch'
    assert first_gen['attrs']['id'] == batch['attrs']['id']
    (png,) = recs['pm.serve.png']
    assert png['attrs']['id'] not in ids
    assert png['attrs']['id'] in recs['pm.serve.batch'][1]['attrs']['requests']


def test_nearest_rank():
    v = list(range(1, 11))
    assert _nearest_rank(v, 0.5) == 5 and _nearest_rank(v, 0.95) == 10
    assert _nearest_rank(v, 0.9) == 9 and _nearest_rank([3.0], 0.95) == 3.0
    assert _nearest_rank([], 0.5) is None


def test_stats_latency_counts_the_tower(dense, monkeypatch):
    embed = dense.embed_text

    def slow_tower(text):
        if not isinstance(text, list):      # contexts, or None
            return embed(text)
        time.sleep(0.05)
        return torch.zeros(len(text), 5, 48)

    monkeypatch.setattr(dense, 'embed_text', slow_tower)
    with GenerationEngine(dense, max_batch=1, max_wait_ms=1) as eng:
        with profiling.recording():
            eng.submit(GenerateRequest(text='a prompt',
                                       timesteps=1)).result(timeout=120)
        stats = eng.stats()
    assert stats['latency_p50_s'] >= 0.05
    assert stats['latency_p95_s'] == stats['latency_p50_s']
    assert 0 <= stats['queue_wait_p50_s'] <= stats['queue_wait_p90_s'] \
        < stats['latency_p50_s'] - 0.05
    for key in ('requests', 'batches', 'batched_requests', 'errors',
                'padded_slots', 'rejected', 'queue_depth',
                'mean_batch_occupancy'):
        assert key in stats
    (tower,) = _by_name(profiling.records())['pm.serve.tower']
    assert tower['end_ns'] - tower['start_ns'] >= 50_000_000
