"""HTTP serving under an open loop of Poisson arrivals.

The server is the port's own (``serving.server.make_server`` over a
``GenerationEngine``, with the engine's command-line defaults unless the
traffic file sets ``max_batch`` / ``max_wait_ms``), in this process, on
127.0.0.1 at an ephemeral port; the pipeline conditions on a seeded
flan-T5 tower behind the stand-in tokenizer.  The client
(``http_client.py``) is a process of its own that this generator starts and
waits for; the window is its schedule, ``seconds`` long, and every request
due in it is waited for.

Latency is timed by the client from when a request was due to the last
byte of its answer.  Hooks keep what the check judges: the tower's output
for each prompt, each engine batch's contexts, step tokens and decoded
codes (``check.judge_serving``).
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import check as judge  # noqa: E402
import program  # noqa: E402
import weights as seeded  # noqa: E402
from tokenizer import hash_tokenizer  # noqa: E402


class State:
    pass


def setup(run):
    from paintmind_tpu_torch.models import t5 as pt5
    from paintmind_tpu_torch.serving import engine as peng
    from paintmind_tpu_torch.serving import server as psrv
    cfg, tr = run.cell.config, run.cell.traffic
    s = State()
    s.run, s.cfg, s.tr = run, cfg, tr
    dtype = program.DTYPES[cfg['compute_dtype']]
    w = seeded.make(cfg, run.rng_seed('weights'), run.device, dtype)
    tw = seeded.make_tower(cfg['tower'], run.rng_seed('tower'), run.device,
                           program.DTYPES[cfg['tower']['dtype']])
    tcfg = {k: v for k, v in cfg['tower'].items()
            if k in pt5.T5Config.__dataclass_fields__}
    enc = pt5.T5Encoder(pt5.T5Config(**tcfg), device='meta')
    enc = enc.to_empty(device=run.device)
    enc.load_state_dict(tw.tensors(), strict=True)
    tower = pt5.T5TextEncoder(model=enc, tokenizer=hash_tokenizer,
                              max_length=cfg['tower']['max_length'],
                              dtype=program.DTYPES[cfg['tower']['dtype']],
                              device=run.device)
    s.pipe = program.build_pipeline(cfg, w.tensors(), run.device,
                                    text_encoder=tower)
    if run.control == 'program':
        s.pipe.quantize('w8a8')
    s.weights, s.tower_weights = w.to('cpu'), tw.to('cpu')
    del w, tw
    s.batches, s.encodes = [], []
    s.hooks = [
        s.pipe.transformer.register_forward_pre_hook(
            lambda m, a: _keep_step(s, a)),
        s.pipe.vqgan.post_quant.register_forward_pre_hook(
            lambda m, a: s.batches[-1]['codes'].append(a[0])
            if s.batches else None),
        enc.register_forward_hook(
            lambda m, a, out: s.encodes.append((a[0], out)))]
    s.engine = peng.GenerationEngine(s.pipe, max_batch=tr['max_batch'],
                                     max_wait_ms=tr['max_wait_ms'])
    s.server = psrv.make_server(s.engine, '127.0.0.1', 0)
    s.port = s.server.server_address[1]
    s.thread = threading.Thread(target=s.server.serve_forever, daemon=True)
    s.thread.start()
    _warm(s, peng)
    s.batches.clear()
    s.encodes.clear()
    s.engine.reset_stats()
    if run.device != 'cpu':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return s


def _keep_step(s, args):
    """One entry a sampler step, a new batch after every ``timesteps``
    steps (each request of the mix runs that many); the batch's contexts
    from its first call.  Nothing here waits for the device."""
    tokens = args[0]
    context = args[1] if len(args) > 1 else None
    cur = s.batches[-1] if s.batches else None
    if cur is not None and cur['steps'] and cur['steps'][-1] is tokens:
        return
    if cur is None or len(cur['steps']) == s.tr['timesteps']:
        cur = {'steps': [], 'codes': [], 'context': context}
        s.batches.append(cur)
    cur['steps'].append(tokens)


def _warm(s, peng):
    """Every bucket the mix reaches (powers of two up to ``max_batch``) for
    each kind of request, two steps each, through the engine's own call;
    then one request over HTTP (tower, PNG, a handler thread)."""
    b = 1
    ctx = torch.zeros(s.tr['max_batch'], s.cfg['tower']['max_length'],
                      s.cfg['t5_dim'], device=s.run.device)
    while b <= s.tr['max_batch']:
        for m in s.tr['mix']:
            s.pipe.generate(text=ctx[:b], timesteps=2, topk=m['topk'],
                            temperature=np.ones(b, np.float32),
                            guidance_scale=np.full(b, m['guidance_scale'],
                                                   np.float32),
                            decode_steps='final')
        b *= 2
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', s.port, timeout=120)
    m = s.tr['mix'][0]
    conn.request('POST', '/generate', json.dumps(
        {'prompt': 'warm up', 'timesteps': 2, 'topk': m['topk'],
         'guidance_scale': m['guidance_scale']}).encode(),
        {'Content-Type': 'application/json'})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f'warm-up request: HTTP {resp.status}')


def window(s, seconds):
    fd, path = tempfile.mkstemp(suffix='.jsonl')
    os.close(fd)
    fd, tpath = tempfile.mkstemp(suffix='.json')
    with os.fdopen(fd, 'w') as f:
        json.dump(s.tr, f)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, 'http_client.py'),
             '--port', str(s.port), '--traffic', tpath,
             '--seed', str(s.run.rng_seed('client')), '--seconds',
             str(seconds), '--out', path],
            timeout=seconds + s.tr['grace'] + 120, capture_output=True,
            text=True)
        elapsed = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError('client failed: ' + proc.stderr[-2000:])
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    finally:
        os.unlink(path)
        os.unlink(tpath)
    stats = s.engine.stats()
    ok = [r for r in recs if r['status'] == 200]
    lat = np.array([r['done'] - r['due'] for r in ok])
    late = np.array([r['sent'] - r['due'] for r in recs if 'sent' in r])
    return {'seconds': elapsed, 'window': seconds, 'requests': recs,
            'attempted': len(recs), 'failed': len(recs) - len(ok),
            'latency': lat, 'engine': stats,
            'send_late_p95_s': float(np.percentile(late, 95)) if late.size else None,
            'send_late_max_s': float(late.max()) if late.size else None}


def end_to_end(s, stats):
    lat = stats['latency']
    return {'latency_p90_s': float(np.percentile(lat, 90)),
            'latency_p50_s': float(np.percentile(lat, 50))}


def trace_hooks(s):
    return []


def counters(s, stats):
    e = stats['engine']
    return {'padded_slots': e['padded_slots'],
            'batched_requests': e['batched_requests'],
            'batches': e['batches']}


def release(s):
    s.server.shutdown()
    s.server.server_close()
    s.engine.close(timeout=60)
    for h in s.hooks:
        h.remove()
    del s.pipe, s.engine, s.server
    gc.collect()
    if s.run.device != 'cpu':
        torch.cuda.empty_cache()


def check(s, stats):
    return judge.judge_serving(s, stats, s.run.cell.check)
