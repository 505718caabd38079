"""Seeded weights of a configuration, made on the device in a few calls.

The names and shapes are those of the published PaintMind layout (the
stage-1 ViT-VQGAN, the stage-2 transformer and the mask token), worked out
here from the configuration file alone.  One ``torch.randn`` draws every
random number in the served type; each tensor is then a scaled view of it:
Xavier-normal matrices, small random biases, LayerNorm gains near 1, the
position tables at ``dim ** -0.5``, a unit-normal codebook.  A
configuration with a ``router_init`` then has its routers fitted to a
trained router's load (``router_fit.py``).  The program and the reference
receive the same values.
"""

from __future__ import annotations

import math

import torch

import router_fit
from flops import swiglu_hidden


def _block(p, dim, heads, dim_head, mlp_dim, cross, ctx_dim, experts=0):
    inner = heads * dim_head
    hid = swiglu_hidden(mlp_dim)
    out = [(p + 'norm1.weight', (dim,), 'ln_w'), (p + 'norm1.bias', (dim,), 'bias')]
    attns = [('attn1.', dim)] + ([('attn2.', ctx_dim)] if cross else [])
    for a, c in attns:
        out += [(p + a + 'to_q.weight', (inner, dim), 'mat'),
                (p + a + 'to_k.weight', (inner, c), 'mat'),
                (p + a + 'to_v.weight', (inner, c), 'mat'),
                (p + a + 'to_out.weight', (dim, inner), 'mat'),
                (p + a + 'to_out.bias', (dim,), 'bias')]
    norms = ['norm2.', 'norm3.'] if cross else ['norm2.']
    for n in norms:
        out += [(p + n + 'weight', (dim,), 'ln_w'), (p + n + 'bias', (dim,), 'bias')]
    if experts:
        f = p + 'ffnet.'
        out += [(f + 'router.weight', (experts, dim), 'mat'),
                (f + 'experts.w12.weight', (experts, 2 * hid, dim), 'mat'),
                (f + 'experts.w12.bias', (experts, 2 * hid), 'bias'),
                (f + 'experts.w3.weight', (experts, dim, hid), 'mat'),
                (f + 'experts.w3.bias', (experts, dim), 'bias')]
    else:
        out += [(p + 'ffnet.w12.weight', (2 * hid, dim), 'mat'),
                (p + 'ffnet.w12.bias', (2 * hid,), 'bias'),
                (p + 'ffnet.w3.weight', (dim, hid), 'mat'),
                (p + 'ffnet.w3.bias', (dim,), 'bias')]
    return out


def _vit(p, c, encoder):
    grid = c['image_size'] // c['patch_size']
    patch = c['patch_size'] ** 2 * 3
    out = [(p + 'pos_embed', (1, grid * grid, c['dim']), 'pos')]
    if encoder:
        out += [(p + 'patch_embed.weight', (c['dim'], patch), 'mat'),
                (p + 'norm_pre.weight', (c['dim'],), 'ln_w'),
                (p + 'norm_pre.bias', (c['dim'],), 'bias')]
    for i in range(c['depth']):
        out += _block(f'{p}layers.{i}.', c['dim'], c['num_head'],
                      c['dim_head'], c['mlp_dim'], False, None)
    if not encoder:
        out += [(p + 'norm.weight', (c['dim'],), 'ln_w'),
                (p + 'norm.bias', (c['dim'],), 'bias'),
                (p + 'proj.weight', (patch, c['dim']), 'mat'),
                (p + 'proj.bias', (patch,), 'bias')]
    return out


def spec(config):
    """[(name, shape, kind)] of every tensor of the pipeline."""
    s1, p2 = config['stage1'], config['pipeline']
    e, dim = s1['embed_dim'], p2['dim']
    grid = s1['enc']['image_size'] // s1['enc']['patch_size']
    out = [('mask_token', (1, e), 'small')]
    out += _vit('vqgan.encoder.', s1['enc'], True)
    out += _vit('vqgan.decoder.', s1['dec'], False)
    out += [('vqgan.quantize.codebook', (s1['n_embed'], e), 'unit'),
            ('vqgan.prev_quant.weight', (e, s1['enc']['dim']), 'mat'),
            ('vqgan.prev_quant.bias', (e,), 'bias'),
            ('vqgan.post_quant.weight', (s1['dec']['dim'], e), 'mat'),
            ('vqgan.post_quant.bias', (s1['dec']['dim'],), 'bias')]
    t = 'transformer.'
    out += [(t + 'pos_embed', (1, grid * grid, dim), 'pos'),
            (t + 'token_proj.weight', (dim, e), 'mat'),
            (t + 'token_proj.bias', (dim,), 'bias')]
    for i in range(p2['depth']):
        out += _block(f'{t}layers.{i}.', dim, p2['num_head'], p2['dim_head'],
                      p2['mlp_dim'], True, dim, p2.get('num_experts', 0))
    out += [(t + 'norm.weight', (dim,), 'ln_w'), (t + 'norm.bias', (dim,), 'bias'),
            (t + 'to_logits.weight', (s1['n_embed'], dim), 'mat'),
            (t + 'to_logits.bias', (s1['n_embed'],), 'bias')]
    if config['t5_dim'] != dim:
        out.append((t + 'context_proj.weight', (dim, config['t5_dim']), 'mat'))
    return out


def _scale(shape, kind):
    if kind == 'mat':
        fan_out, fan_in = shape[-2], shape[-1]
        return math.sqrt(2.0 / (fan_in + fan_out))
    return {'bias': 0.02, 'ln_w': 0.05, 'pos': shape[-1] ** -0.5,
            'unit': 1.0, 'small': 0.02}[kind]


class Weights:
    """Every tensor of a configuration as a view of one flat buffer, so
    that the whole set moves between host and card in one copy.
    ``router_fit``: the fit's report a routed layer, where there was one."""

    router_fit = None

    def __init__(self, flat, items):
        self.flat, self.items = flat, items

    def tensors(self):
        """{name: view} of the buffer where it now lies."""
        out, at = {}, 0
        for name, shape, _ in self.items:
            n = math.prod(shape)
            out[name] = self.flat[at:at + n].view(shape)
            at += n
        return out

    def to(self, device):
        return Weights(self.flat.to(device), self.items)


def make(config, seed, device, dtype):
    """The seeded ``Weights`` of ``config`` on ``device`` in ``dtype``,
    its routers fitted where the configuration has a ``router_init``.  A
    configuration with a ``weights_seed`` is drawn from that seed whatever
    ``seed`` is."""
    seed = config.get('weights_seed', seed)
    items = spec(config)
    total = sum(math.prod(s) for _, s, _ in items)
    g = torch.Generator(device=device).manual_seed(int(seed))
    w = Weights(torch.randn(total, generator=g, device=device, dtype=dtype),
                items)
    with torch.no_grad():
        for (name, shape, kind), t in zip(items, w.tensors().values()):
            t.mul_(_scale(shape, kind))
            if kind == 'ln_w':
                t.add_(1.0)
    if config.get('router_init'):
        w.router_fit = router_fit.fit(w, config, seed)
    return w


def tower_spec(tower):
    """[(name, shape, kind)] of the flan-T5 encoder's tensors."""
    d, inner, ff = tower['d_model'], tower['num_heads'] * tower['d_kv'], tower['d_ff']
    q = (d * tower['d_kv']) ** -0.5
    out = [('embed.weight', (tower['vocab_size'], d), 1.0),
           ('rel_bias.weight', (tower['rel_buckets'], tower['num_heads']),
            d ** -0.5)]
    for i in range(tower['num_layers']):
        p = f'blocks.{i}.'
        out += [(p + 'ln0.weight', (d,), 'ln_w'),
                (p + 'q.weight', (inner, d), q),
                (p + 'k.weight', (inner, d), d ** -0.5),
                (p + 'v.weight', (inner, d), d ** -0.5),
                (p + 'o.weight', (d, inner), inner ** -0.5),
                (p + 'ln1.weight', (d,), 'ln_w'),
                (p + 'wi_0.weight', (ff, d), d ** -0.5),
                (p + 'wi_1.weight', (ff, d), d ** -0.5),
                (p + 'wo.weight', (d, ff), ff ** -0.5)]
    return out + [('final_ln.weight', (d,), 'ln_w')]


def make_tower(tower, seed, device, dtype=torch.float32):
    """The seeded ``Weights`` of the text tower at the published T5
    initialisation's scales (Mesh TensorFlow / Hugging Face
    ``T5PreTrainedModel._init_weights``: q by (d_model d_kv) ** -0.5, so
    that the unscaled attention logits are of order one; k, v, wi by
    d_model ** -0.5; o by (heads d_kv) ** -0.5; wo by d_ff ** -0.5; the
    embedding unit-normal), norm gains near 1."""
    items = tower_spec(tower)
    total = sum(math.prod(s) for _, s, _ in items)
    g = torch.Generator(device=device).manual_seed(int(seed))
    w = Weights(torch.randn(total, generator=g, device=device, dtype=dtype),
                items)
    with torch.no_grad():
        for (name, shape, scale), t in zip(items, w.tensors().values()):
            if scale == 'ln_w':
                t.mul_(0.05).add_(1.0)
            else:
                t.mul_(scale)
    return w
