"""Operation and byte counts, from a configuration's shapes alone.

A multiply-add is two operations.  The counts cover the work the inputs
need: not the padding a kernel computes, not MoE slots that routing leaves
empty (``filled`` is the share of the k slots a token asks for that it got;
1 where nothing was dropped).

Per token and transformer pass, with d = dim, h = the SwiGLU hidden width,
N = tokens, M = context rows, V = codes:

* self-attention: projections 8 d^2, products 4 N d;
* cross-attention: q and out projections 4 d^2, k and v over the context
  4 M d^2 / N, products 4 M d; the unconditional pass self-attends instead;
* SwiGLU 6 d h; routed: router 2 d E plus k * filled * 6 d h;
* token projection 2 e d (e the code width).

The vocabulary head, 2 d V, counts once per position and step: guidance is
affine and the head linear, so one head over the mixed state gives the
mixed logits.  The VQGAN decode of the final ids runs the decoder blocks
(self-attention and SwiGLU at the decoder's width), the post-quant and the
patch projection.
"""

from __future__ import annotations


def swiglu_hidden(mlp_dim):
    return (int(mlp_dim * 2 / 3) + 7) // 8 * 8


def pass_flops_per_token(config, ctx_len, cond, filled=1.0):
    """One transformer pass (no head), per token."""
    p, s1 = config['pipeline'], config['stage1']
    d = p['dim']
    n = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    h = swiglu_hidden(p['mlp_dim'])
    self_attn = 8 * d * d + 4 * n * d
    if cond:
        cross = 4 * d * d + 4 * ctx_len * d * d / n + 4 * ctx_len * d
    else:
        cross = self_attn
    if p.get('num_experts'):
        ffn = 2 * d * p['num_experts'] + p['num_selected'] * filled * 6 * d * h
    else:
        ffn = 6 * d * h
    return 2 * s1['embed_dim'] * d + p['depth'] * (self_attn + cross + ffn)


def head_flops_per_token(config):
    return 2 * config['pipeline']['dim'] * config['stage1']['n_embed']


def decode_flops_per_image(config):
    s1 = config['stage1']
    c = s1['dec']
    n = (c['image_size'] // c['patch_size']) ** 2
    d = c['dim']
    inner = c['num_head'] * c['dim_head']
    block = 8 * d * inner + 4 * n * inner + 6 * d * swiglu_hidden(c['mlp_dim'])
    proj = 2 * d * c['patch_size'] ** 2 * 3 + 2 * s1['embed_dim'] * d
    return n * (c['depth'] * block + proj)


def generate_flops(config, batch, steps, ctx_len, guided, filled=1.0):
    """Model operations of one ``generate`` call decoding its final ids."""
    s1 = config['stage1']
    n = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    per_tok = pass_flops_per_token(config, ctx_len, True, filled)
    if guided:
        per_tok += pass_flops_per_token(config, ctx_len, False, filled)
    per_tok += head_flops_per_token(config)
    return batch * (n * steps * per_tok + decode_flops_per_image(config))


def attention_cost(b, heads, n, m, dim_head, elem_bytes=2, backward=False):
    """(operations, bytes) that one attention call needs: q.k and p.v are
    4 b h n m d operations (the backward's five products 10 b h n m d);
    q, k, v read once and o written once (the backward reads q, k, v, o,
    the output gradient and the fp32 log-sum-exp, and writes dq, dk,
    dv)."""
    ops = (10 if backward else 4) * b * heads * n * m * dim_head
    qo = b * n * heads * dim_head * elem_bytes
    kv = b * m * heads * dim_head * elem_bytes
    if backward:
        nbytes = 3 * qo + 2 * kv + 4 * b * heads * n + qo + 2 * kv
    else:
        nbytes = 2 * qo + 2 * kv
    return ops, nbytes


def bound_seconds(ops, nbytes, peaks, dtype='bf16'):
    """The least time the chip could take: operations or bytes, whichever
    bounds it."""
    return max(ops / peaks[f'{dtype}_flops'], nbytes / peaks['hbm_bytes_per_s'])


def generate_attention_calls(config, batch, steps, ctx_len, guided):
    """[(count, b, heads, n, m, dim_head)] of the attention calls of one
    ``generate`` call: per step and layer the conditional pass's self- and
    cross-attention, and with guidance the unconditional pass's two
    self-attentions; then the decoder's layers."""
    p, s1 = config['pipeline'], config['stage1']
    n = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    per = steps * p['depth']
    self_calls = per * (3 if guided else 1)
    calls = [(self_calls, batch, p['num_head'], n, n, p['dim_head']),
             (per, batch, p['num_head'], n, ctx_len, p['dim_head'])]
    c = s1['dec']
    nd = (c['image_size'] // c['patch_size']) ** 2
    calls.append((c['depth'], batch, c['num_head'], nd, nd, c['dim_head']))
    return calls


def encode_flops_per_image(config):
    """The frozen VQGAN encode of one image: patch embedding, the encoder
    blocks, ``prev_quant`` and the nearest-code search (kernel K2)."""
    s1 = config['stage1']
    c = s1['enc']
    n = (c['image_size'] // c['patch_size']) ** 2
    d = c['dim']
    inner = c['num_head'] * c['dim_head']
    block = 8 * d * inner + 4 * n * inner + 6 * d * swiglu_hidden(c['mlp_dim'])
    per_tok = (2 * c['patch_size'] ** 2 * 3 * d + c['depth'] * block
               + 2 * d * s1['embed_dim'] + 2 * s1['embed_dim'] * s1['n_embed'])
    return n * per_tok


def train_update_flops(config, batch, ctx_len, text):
    """One update: the transformer's forward and backward (three times its
    forward; the masked tokens' every position passes), the head, and the
    frozen encode's forward.  ``text``: whether the context was kept."""
    s1 = config['stage1']
    n = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    fwd = pass_flops_per_token(config, ctx_len, text) + head_flops_per_token(config)
    return batch * (3 * n * fwd + encode_flops_per_image(config))


def train_attention_calls(config, batch, ctx_len, text):
    """[(count, b, heads, n, m, dim_head)] of one update's attention
    backward calls (kernel K4): each layer's self-attention and its
    cross-attention (self-attention when the text was dropped)."""
    p, s1 = config['pipeline'], config['stage1']
    n = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    d = p['depth']
    if not text:
        return [(2 * d, batch, p['num_head'], n, n, p['dim_head'])]
    return [(d, batch, p['num_head'], n, n, p['dim_head']),
            (d, batch, p['num_head'], n, ctx_len, p['dim_head'])]
