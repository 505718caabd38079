"""Offline batch generation by block diffusion: back-to-back
``Pipeline.generate`` calls of a block-diffusion version (``sdar-30b-a3b``).

Traffic parameters (``traffic/<name>.json``): ``batch``, ``topk``,
``temperature``, ``context_len``, ``context_scale`` (the seeded contexts'
standard deviation), ``context_pool`` (distinct context batches, used in
turn).  The block length and the steps a block are the configuration's
(``pipeline.block_len``, ``pipeline.block_steps``); the calls are unguided.

The weights are drawn in place in the built pipeline, each tensor from a
seed of (the configuration's ``weights_seed``, its name)
(``draw_weights``), so that no second copy of the ~60 GB exists on the card
or on the host; the check draws them again, one layer at a time.

Each call decodes its final ids and ends in ``torch.cuda.synchronize``; the
window runs whole calls until ``seconds`` have passed (and at least until
the call the check samples).  A forward pre-hook on the transformer keeps
each pass's input tokens (every block's steps and its commit pass), one on
the VQGAN's ``post_quant`` the decoded codes; for the call drawn from the
seed a forward hook on the vocabulary head keeps the drawn rows' logits at
the drawn (block, step) pairs, and after that call the drawn rows of the
drawn layers' KV cache are copied as its last pass left them (the
transformer keeps one cache a batch shape: ``SDARTransformer.cache``).
After the window ``check_blocks.judge`` reads them.
"""

from __future__ import annotations

import gc
import hashlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import check_blocks as judge  # noqa: E402
import program  # noqa: E402
from weights import _scale  # noqa: E402


class State:
    pass


def _kind(name, shape):
    """The initialiser's kind of a pipeline tensor, from its name
    (``weights._scale``'s kinds)."""
    if name.endswith('codebook'):
        return 'unit'
    if name == 'mask_token':
        return 'small'
    if name.endswith('pos_embed'):
        return 'pos'
    if name.endswith('.bias'):
        return 'bias'
    return 'ln_w' if len(shape) == 1 else 'mat'


def tensor_seed(weights_seed, name):
    h = hashlib.sha256(repr((int(weights_seed), name)).encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


def draw(weights_seed, name, shape, device):
    """The fp32 draw of one tensor: Xavier-normal matrices (over the last
    two axes), small biases, norm gains near 1, position tables at
    ``dim ** -0.5``, a unit-normal codebook (``weights._scale``)."""
    kind = _kind(name, shape)
    g = torch.Generator(device=device).manual_seed(
        tensor_seed(weights_seed, name))
    t = torch.randn(shape, generator=g, device=device).mul_(_scale(shape, kind))
    return t.add_(1.0) if kind == 'ln_w' else t


@torch.no_grad()
def draw_weights(pipe, weights_seed):
    """Every tensor of ``pipe`` drawn in place, in its own type."""
    for name, t in pipe.state_dict().items():
        t.copy_(draw(weights_seed, name, tuple(t.shape), t.device))


class Weights:
    """The pipeline's tensors as the reference reads them: fp32 values of
    what the program holds (the draw rounded to the served type), the
    top-level ones kept, a layer's drawn when a name of it is asked for
    and dropped when another layer's is."""

    def __init__(self, shapes, weights_seed, dtype, device):
        self.shapes, self.seed = shapes, weights_seed
        self.dtype, self.device = dtype, device
        self.top = {n: self._draw(n) for n in shapes
                    if not n.startswith('transformer.layers.')}
        self.layer, self.held = None, {}

    def _draw(self, name):
        return draw(self.seed, name, self.shapes[name],
                    self.device).to(self.dtype).float()

    def __getitem__(self, name):
        if name in self.top:
            return self.top[name]
        prefix = '.'.join(name.split('.')[:3]) + '.'
        if prefix != self.layer:
            self.held = {}
            self.held = {n: self._draw(n) for n in self.shapes
                         if n.startswith(prefix)}
            self.layer = prefix
        return self.held[name]

    def __contains__(self, name):
        return name in self.shapes


def setup(run):
    # a program without the block-diffusion stack fails here, at once
    from paintmind_tpu_torch.models import sdar_transformer  # noqa: F401
    import paintmind_tpu_torch as pt
    cfg, tr = run.cell.config, run.cell.traffic
    s = State()
    s.run, s.cfg, s.tr = run, cfg, tr
    dtype = program.DTYPES[cfg['compute_dtype']]
    name = 'bench-' + cfg['name']
    pt.register_version(name + '-stage1', cfg['stage1'])
    pt.register_version(name, dict(cfg['pipeline'], stage1=name + '-stage1'))
    s.pipe = pt.create_model('pipeline', name, pretrained=False,
                             device=run.device, text_encoder=None,
                             param_dtype=dtype, compute_dtype=dtype)
    s.weights_seed = cfg['weights_seed']
    draw_weights(s.pipe, s.weights_seed)
    shapes = {n: tuple(t.shape) for n, t in s.pipe.state_dict().items()}
    s.reference_weights = lambda: Weights(shapes, s.weights_seed, dtype,
                                          run.device)
    g = torch.Generator(device=run.device).manual_seed(run.rng_seed('contexts'))
    shape = (tr['context_pool'], tr['batch'], tr['context_len'], cfg['t5_dim'])
    s.contexts = (torch.randn(shape, generator=g, device=run.device,
                              dtype=dtype) * tr['context_scale'])
    s.gen = torch.Generator(device=run.device).manual_seed(
        run.rng_seed('sampler'))
    p = cfg['pipeline']
    s.blocks = (cfg['stage1']['enc']['image_size']
                // cfg['stage1']['enc']['patch_size']) ** 2 // p['block_len']
    s.sample = judge.sample(run, s.blocks, p['block_steps'], tr['batch'],
                            p['depth'])
    s.cur = {'passes': [], 'codes': [], 'logits': None, 'kv': None}
    tr_mod = s.pipe.transformer
    s.hooks = [
        tr_mod.register_forward_pre_hook(
            lambda m, a: s.cur['passes'].append(a[0])),
        tr_mod.to_logits.register_forward_hook(
            lambda m, a, out: _keep_logits(s, out)),
        s.pipe.vqgan.post_quant.register_forward_pre_hook(
            lambda m, a: s.cur['codes'].append(a[0]))]
    s.out = None
    _call(s, 0)            # warm-up: every shape of the window
    _sync(run.device)
    s.out = []
    if run.device != 'cpu':
        torch.cuda.reset_peak_memory_stats()
    return s


def _pass(s):
    """(block, step) of the pass under way; step == steps: the commit."""
    steps = s.cfg['pipeline']['block_steps']
    return divmod(len(s.cur['passes']) - 1, steps + 1)


def _keep_logits(s, out):
    keep = s.cur['logits']
    if keep is not None and _pass(s) in s.sample['pairs']:
        keep[_pass(s)] = out[s.sample['rows']].clone()


def _keep_cache(s, context):
    """The drawn rows of the drawn layers' cache as the call left it."""
    tr = s.pipe.transformer
    cache = tr.cache(context.shape[0], context.shape[1] + tr.cfg.len_seq,
                     dtype=context.dtype, device=context.device)
    return {i: tuple(c[s.sample['rows']].clone() for c in cache[i])
            for i in s.sample['layers']}


def _sync(device):
    if device != 'cpu':
        torch.cuda.synchronize()


def _call(s, i):
    tr = s.tr
    drawn = s.out is not None and len(s.out) == s.sample['call']
    s.cur = cur = {'passes': [], 'codes': [],
                   'logits': {} if drawn else None, 'kv': None}
    context = s.contexts[i % tr['context_pool']]
    imgs = s.pipe.generate(text=context, temperature=tr['temperature'],
                           topk=tr['topk'], generator=s.gen)
    if drawn:
        cur['kv'] = _keep_cache(s, context)
    if s.out is None:
        return
    s.out.append({'ctx': i % tr['context_pool'], 'passes': cur['passes'],
                  'codes': cur['codes'], 'images': imgs[-1],
                  'logits': cur['logits'], 'kv': cur['kv']})


def _launches():
    """The port's kernel launch counters (``program.kernel_counters``) and
    those of K5 and K6, which the stack's passes launch too (a graph's
    replay adds the launches its capture made)."""
    from paintmind_tpu_torch.ops import moe_experts, rope
    return dict(program.kernel_counters(), K5=moe_experts.launches,
                K6=rope.launches)


def window(s, seconds):
    before = _launches()
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
    after = _launches()
    images = calls * s.tr['batch']
    return {'seconds': elapsed, 'calls': calls, 'images': images,
            'attempted': images, 'failed': 0,
            'launches': {k: after[k] - before[k] for k in after}}


def end_to_end(s, stats):
    return {'images_per_s': stats['images'] / stats['seconds']}


def trace_hooks(s):
    return []


def counters(s, stats):
    return {'calls': stats['calls'], 'launches': stats['launches']}


def release(s):
    for h in s.hooks:
        h.remove()
    del s.pipe
    gc.collect()
    if s.run.device != 'cpu':
        torch.cuda.empty_cache()


def check(s, stats):
    return judge.judge(s, s.run.cell.check)

