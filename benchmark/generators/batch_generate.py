"""Offline batch generation: back-to-back ``Pipeline.generate`` calls.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``timesteps``,
``topk``, ``temperature``, ``guidance_scale`` (null: unguided),
``context_len``, ``context_scale`` (the seeded contexts' standard
deviation), ``context_pool`` (distinct context batches, used in turn).

Each call decodes its final ids only and ends in ``torch.cuda.synchronize``;
the window runs whole calls until ``seconds`` have passed (and at least
until the call the check samples) and keeps each call's duration for the
result line's diagnostics (``call_s``).  Forward pre-hooks on the transformer
and on the VQGAN's ``post_quant`` keep each step's input tokens and the
decoded codes; a forward hook on the vocabulary head keeps, for the call
and steps drawn from the seed (``check.sample``), a copy of the logits of
the rows drawn; after the window the check reads them (``check.py``).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import check as judge  # noqa: E402
import program  # noqa: E402
import weights as seeded  # noqa: E402


class State:
    pass


def setup(run):
    cfg, tr = run.cell.config, run.cell.traffic
    s = State()
    s.run, s.cfg, s.tr = run, cfg, tr
    dtype = program.DTYPES[cfg['compute_dtype']]
    w = seeded.make(cfg, run.rng_seed('weights'), run.device, dtype)
    if w.router_fit:
        print('router fit, kept share of the fit\'s tokens, draw -> fit: '
              + ', '.join(f"{r['kept_before']:.4f} -> {r['kept_after']:.4f}"
                          for r in w.router_fit), file=sys.stderr, flush=True)
    s.pipe = program.build_pipeline(cfg, w.tensors(), run.device)
    s.weights = w.to('cpu')   # the reference's copy, off the card meanwhile
    del w
    if run.control == 'program':
        s.pipe.quantize('w8a8')
    g = torch.Generator(device=run.device).manual_seed(run.rng_seed('contexts'))
    shape = (tr['context_pool'], tr['batch'], tr['context_len'], cfg['t5_dim'])
    s.contexts = (torch.randn(shape, generator=g, device=run.device,
                              dtype=dtype) * tr['context_scale'])
    s.gen = torch.Generator(device=run.device).manual_seed(
        run.rng_seed('sampler'))
    s.sample = judge.sample(run, tr['timesteps'], tr['batch'])
    s.cur = {'steps': [], 'codes': [], 'logits': None}
    s.hooks = [
        s.pipe.transformer.to_logits.register_forward_hook(
            lambda m, a, out: _keep_logits(s, out)),
        s.pipe.transformer.register_forward_pre_hook(
            lambda m, a: _keep(s.cur['steps'], a[0])),
        s.pipe.vqgan.post_quant.register_forward_pre_hook(
            lambda m, a: s.cur['codes'].append(a[0]))]
    s.out = None
    _call(s, 0)            # warm-up: every shape of the window
    _sync(run.device)
    s.out = []
    if run.device != 'cpu':
        torch.cuda.reset_peak_memory_stats()
    s.drops = []
    return s


def _keep_logits(s, out):
    """A copy of the drawn rows' logits at the drawn steps of the drawn
    call (both passes' where guidance mixes logits)."""
    keep = s.cur['logits']
    step = len(s.cur['steps']) - 1
    rows = s.sample['rows']
    if keep is not None and step in s.sample['steps']:
        # a pass over fewer rows than the batch keeps nothing: not judged
        keep.setdefault(step, []).append(
            out[rows].clone() if out.shape[0] > int(rows.max()) else None)


def _keep(steps, tokens):
    """One entry a step: the guided passes share their input tokens."""
    if not steps or steps[-1] is not tokens:
        steps.append(tokens)


def _sync(device):
    if device != 'cpu':
        torch.cuda.synchronize()


def _call(s, i):
    tr = s.tr
    drawn = s.out is not None and len(s.out) == s.sample['call']
    s.cur = cur = {'steps': [], 'codes': [], 'logits': {} if drawn else None}
    imgs = s.pipe.generate(
        text=s.contexts[i % tr['context_pool']], timesteps=tr['timesteps'],
        temperature=tr['temperature'], topk=tr['topk'],
        guidance_scale=tr['guidance_scale'], decode_steps='final',
        generator=s.gen)
    if s.out is None:
        return
    s.out.append({'ctx': i % tr['context_pool'], 'steps': cur['steps'],
                  'codes': cur['codes'], 'images': imgs[-1],
                  'logits': cur['logits']})


def window(s, seconds):
    before = program.kernel_counters()
    t0 = time.perf_counter()
    calls = 0
    ends = []
    while True:
        _call(s, calls)
        _sync(s.run.device)
        calls += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds and calls > s.sample['call']:
            break
    elapsed = time.perf_counter() - t0
    s.call_s = [b - a for a, b in zip([0.0] + ends, ends)]
    after = program.kernel_counters()
    images = calls * s.tr['batch']
    return {'seconds': elapsed, 'calls': calls, 'images': images,
            'attempted': images, 'failed': 0,
            'launches': {k: after[k] - before[k] for k in after}}


def end_to_end(s, stats):
    return {'images_per_s': stats['images'] / stats['seconds']}


def trace_hooks(s):
    """``bench.moe`` ranges around each routed FFN call, and its dropped
    share (the routing's own statistic) kept for the operation count."""
    hooks = []
    for layer in program.routed_layers(s.pipe):
        rng = {}

        def pre(m, a, rng=rng):
            rng['r'] = torch.profiler.record_function('bench.moe')
            rng['r'].__enter__()

        def post(m, a, out, rng=rng):
            rng['r'].__exit__(None, None, None)
            s.drops.append(out[1]['dropped'])

        hooks += [layer.register_forward_pre_hook(pre),
                  layer.register_forward_hook(post)]
    return hooks


def counters(s, stats):
    tr = s.tr
    out = {'calls': stats['calls'], 'launches': stats['launches'],
           'guided': tr['guidance_scale'] is not None}
    if s.drops:
        out['filled'] = 1.0 - float(torch.stack(s.drops).float().mean())
    return out


def release(s):
    for h in s.hooks:
        h.remove()
    del s.pipe
    gc.collect()
    if s.run.device != 'cpu':
        torch.cuda.empty_cache()


def check(s, stats):
    return judge.judge_generate(s, s.run.cell.check)
