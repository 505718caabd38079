"""Operation and byte counts of block-diffusion generation
(``generators/block_generate.py``), from a configuration's shapes alone,
beside ``flops.py``.

A multiply-add is two operations.  With d = dim, H query and Hkv KV heads of
D, E experts of which k a token, expert width h, V codes, e the code width:

* per token and layer: the projections 2 d D (2 H + 2 Hkv), the attention
  products 4 H D m over its m keys, the router 2 d E, the experts
  k · 6 d h (dropless: every assignment is a row);
* the prompt (B·M tokens, M keys each) also ``context_proj`` 2 c d, c the
  context width; a block's pass (B·n tokens over M + n (j + 1) keys at
  block j) also ``token_proj`` 2 e d, and a step's pass the head 2 d V (the
  commit pass forms no logits);
* a call: the prompt's pass, then each block's ``block_steps`` steps and
  its commit pass; the VQGAN decode of the final ids (``flops``).

The norms, RoPE, routing bookkeeping and sampling head are not counted.
"""

from __future__ import annotations

import flops


def _shape(config, traffic):
    p, s1 = config['pipeline'], config['stage1']
    total = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    return (p, traffic['batch'], traffic['context_len'], total,
            p['block_len'], p['block_steps'])


def _layer_per_token(p, keys):
    d, D = p['dim'], p['dim_head']
    proj = 2 * d * D * (2 * p['num_head'] + 2 * p['kv_heads'])
    attn = 4 * p['num_head'] * D * keys
    moe = 2 * d * p['num_experts'] + p['num_selected'] * 6 * d * p['expert_hidden']
    return proj + attn + moe


def call_flops(config, traffic):
    """Model operations of one call, the decode of its final ids included."""
    p, b, m, total, n, steps = _shape(config, traffic)
    d, depth = p['dim'], p['depth']
    e, v = config['stage1']['embed_dim'], config['stage1']['n_embed']
    ops = b * m * (2 * config['t5_dim'] * d + depth * _layer_per_token(p, m))
    for j in range(total // n):
        per = 2 * e * d + depth * _layer_per_token(p, m + n * (j + 1))
        ops += b * n * ((steps + 1) * per + steps * 2 * d * v)
    return ops + b * flops.decode_flops_per_image(config)


def attention_calls(config, traffic):
    """[(count, b, heads, n, m, dim_head, kv_heads)] of one call's K1
    calls: the prompt's pass, each block's passes, the VQGAN decoder."""
    p, b, m, total, n, steps = _shape(config, traffic)
    h, hk, dh, depth = p['num_head'], p['kv_heads'], p['dim_head'], p['depth']
    calls = [(depth, b, h, m, m, dh, hk)]
    calls += [((steps + 1) * depth, b, h, n, m + n * (j + 1), dh, hk)
              for j in range(total // n)]
    c = config['stage1']['dec']
    nd = (c['image_size'] // c['patch_size']) ** 2
    calls.append((c['depth'], b, c['num_head'], nd, nd, c['dim_head'],
                  c['num_head']))
    return calls


def attention_cost(b, heads, n, m, dim_head, kv_heads, elem_bytes=2):
    """(operations, bytes) of one K1 call: 4 b H n m D; q read and o
    written once, K and V read once, each KV head once."""
    qo = 2 * b * n * heads * dim_head * elem_bytes
    kv = 2 * b * m * kv_heads * dim_head * elem_bytes
    return 4 * b * heads * n * m * dim_head, qo + kv


def routed_calls(config, traffic):
    """[(count, tokens)] of one call's routed FFN calls (a layer of a
    pass each)."""
    p, b, m, total, n, steps = _shape(config, traffic)
    return [(p['depth'], b * m),
            (p['depth'] * (steps + 1) * (total // n), b * n)]


def passes(config, traffic):
    """Transformer passes of one call: the prompt's, then each block's
    steps and commit."""
    p, _, _, total, n, steps = _shape(config, traffic)
    return 1 + (total // n) * (steps + 1)


def expert_bound_seconds(config, rows, experts_hit, peaks):
    """The least time of K5 (K5a + K5b) on ``rows`` packed rows over
    ``experts_hit`` experts: its operations, 6 d h a row, or its bytes,
    each hit expert's three d x h matrices once and each row's X read, H
    written and read, O written, whichever bounds it (bf16)."""
    p = config['pipeline']
    d, h = p['dim'], p['expert_hidden']
    ops = 6 * d * h * rows
    nbytes = experts_hit * 3 * d * h * 2 + rows * (2 * d + 2 * h) * 2
    return max(ops / peaks['bf16_flops'], nbytes / peaks['hbm_bytes_per_s'])


def rope_calls(config, traffic):
    """[(count, elements)] of one call's K6 calls (QK-norm and RoPE): q and
    k of every layer of every pass."""
    p, b, m, total, n, steps = _shape(config, traffic)
    heads = p['num_head'] + p['kv_heads']
    return [(p['depth'], b * m * heads * p['dim_head']),
            (p['depth'] * (steps + 1) * (total // n),
             b * n * heads * p['dim_head'])]


def rope_bound_seconds(elements, peaks, elem_bytes=2):
    """The least time of K6 over ``elements`` of q and k: each read once and
    written once (its few operations an element are far below the ridge)."""
    return 2 * elements * elem_bytes / peaks['hbm_bytes_per_s']
