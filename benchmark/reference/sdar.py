"""Plain reference of SDAR-30B-A3B's decoder stack as the stage-2
transformer of the port's ``sdar-30b-a3b`` (block diffusion over the image
codes): no kernel, no KV cache, no batching tricks.

The equations, as published (JetLM ``SDAR-30B-A3B-Chat`` ``config.json``,
``model_type`` ``sdar_moe``: the Qwen3-MoE decoder layer):

* layer: ``x += o(attn(rms1 x)); x += moe(rms2 x)``, RMSNorm ``x /
  sqrt(mean(x²) + eps) · w`` (eps 1e-6);
* attention: bias-free q, k, v, o; grouped-query (each KV head serves
  ``heads / kv_heads`` query heads); QK-norm, an RMSNorm over each head's
  dims of q and of k, then the rotary embedding in the rotate-half
  convention (``x cos + [-x2, x1] sin``, frequency ``theta^(-2i/D)``);
  ``softmax(q kᵀ / sqrt(D)) v`` under the block-causal mask: the prompt
  is block 0, image position i is block ``1 + i // block_len``, and a query
  sees the keys of its own block and the blocks before it;
* the routed FFN: softmax over the experts' logits, the top ``k`` (a stable
  descending sort: ties to the lower expert), the gates renormalised to sum
  to 1 (``norm_topk_prob``), each token's ``k`` bias-free SwiGLU experts
  ``w3(silu(x1) x2)``, ``[x1 | x2] = w12 x``, summed by their gates; no
  capacity, nothing dropped, no shared expert;
* a final RMSNorm and the vocabulary head.

Departures, each the port's (``paintmind_tpu_torch/models/
sdar_transformer.py``): the router runs in fp32 (whatever the activations'
type); the text embedding and the 151936-row head are the pipeline's
``token_proj`` of the 32-wide VQGAN code vectors (with bias), the prompt is
the (B, M, 1024) context through ``context_proj`` at positions [0, M), and
the head ``to_logits`` (with bias) is over the 8192 codes.

Without a cache the whole sequence [prompt; blocks so far] runs under the
explicit mask: the K/V of a position depend on its block and the blocks
before it alone, which is what makes the port's cached passes equal to it.

Computed in float32 with TF32 off (``model.fp32_mode``), or, for the
control, with every product's operands rounded to fp8 e4m3
(``lowp='fp8'``, ``model.linear``).  The weights are a mapping from the
pipeline's parameter names (``state_dict``) to tensors, read one layer at a
time (``forward`` asks for layer i's names only while it runs layer i).
Imports nothing but torch and the benchmark's ``reference.model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import LOWP, linear

T = 'transformer.'


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta):
    """x (B, N, H, D) rotated at positions ``pos`` (N,)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = pos.double()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def block_ids(prompt, tokens, block_len, device=None):
    """Block of each position of [prompt; tokens]: 0 for the prompt, then
    1 + i // block_len for image position i."""
    img = 1 + torch.arange(tokens, device=device) // block_len
    return torch.cat([torch.zeros(prompt, dtype=img.dtype, device=device),
                      img])


def attention(W, p, x, cfg, blocks, lowp=None):
    """Block-causal GQA self-attention of x (B, S, dim) -> (out, k, v),
    k and v (B, S, kv_heads, D) as the cache holds them (k after QK-norm
    and RoPE)."""
    b, s, _ = x.shape
    h, hk, d = cfg['num_head'], cfg['kv_heads'], cfg['dim_head']
    eps = cfg['rms_eps']
    q = linear(x, W[p + 'to_q.weight'], lowp=lowp).reshape(b, s, h, d)
    k = linear(x, W[p + 'to_k.weight'], lowp=lowp).reshape(b, s, hk, d)
    v = linear(x, W[p + 'to_v.weight'], lowp=lowp).reshape(b, s, hk, d)
    pos = torch.arange(s, device=x.device)
    q = rms_norm(q, W[p + 'q_norm.weight'], eps)
    k = rms_norm(k, W[p + 'k_norm.weight'], eps)
    q, k = rope(q, pos, cfg['rope_theta']), rope(k, pos, cfg['rope_theta'])
    kr = k.repeat_interleave(h // hk, dim=2)
    vr = v.repeat_interleave(h // hk, dim=2)
    if lowp is not None:      # the products' operands rounded as well
        q, kr, vr = (LOWP[lowp](t, -1) for t in (q, kr, vr))
    scores = torch.einsum('bnhd,bmhd->bhnm', q, kr) * d ** -0.5
    hidden = blocks[None, :] > blocks[:, None]          # (S, S): key after
    scores = scores.masked_fill(hidden, float('-inf'))
    out = torch.einsum('bhnm,bmhd->bnhd', torch.softmax(scores, -1), vr)
    return linear(out.reshape(b, s, h * d), W[p + 'to_out.weight'],
                  lowp=lowp), k, v


def routed(W, p, x, cfg, lowp=None):
    """The dropless top-k routed FFN over the rows of x (..., dim)."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1]).float()
    k = cfg['num_selected']
    probs = torch.softmax(xt @ W[p + 'router.weight'].float().t(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, :k], order.indices[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    w12, w3 = W[p + 'experts.w12.weight'], W[p + 'experts.w3.weight']
    y = torch.zeros_like(xt)
    for ex in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)
        hid = linear(xt[tok], w12[ex], lowp=lowp)
        x1, x2 = hid.chunk(2, dim=-1)
        out = linear(F.silu(x1) * x2, w3[ex], lowp=lowp)
        y.index_add_(0, tok, out * gate[tok, slot][:, None])
    return y.reshape(shape)


def layer(W, cfg, i, xs, blocks, lowp=None):
    """Layer ``i`` over each (B, S, dim) sequence of ``xs`` with its block
    ids; the routed FFN runs once over all their rows.  Returns the new
    sequences and each one's (k, v)."""
    p = f'{T}layers.{i}.'
    eps = cfg['rms_eps']
    outs, kvs = [], []
    for x, blk in zip(xs, blocks):
        a, k, v = attention(W, p + 'attn.', rms_norm(x, W[p + 'norm1.weight'],
                                                      eps), cfg, blk, lowp)
        outs.append(x + a)
        kvs.append((k, v))
    flat = torch.cat([rms_norm(x, W[p + 'norm2.weight'], eps).reshape(
        -1, x.shape[-1]) for x in outs])
    ffn = routed(W, p + 'ffnet.', flat, cfg, lowp)
    res, at = [], 0
    for x in outs:
        n = x.shape[0] * x.shape[1]
        res.append(x + ffn[at:at + n].reshape(x.shape))
        at += n
    return res, kvs


def prompt_in(W, context, lowp=None):
    return linear(context.float(), W[T + 'context_proj.weight'], lowp=lowp)


def tokens_in(W, tokens, lowp=None):
    return linear(tokens.float(), W[T + 'token_proj.weight'],
                  W[T + 'token_proj.bias'], lowp)


def head(W, cfg, x, lowp=None):
    x = rms_norm(x, W[T + 'norm.weight'], cfg['rms_eps'])
    return linear(x, W[T + 'to_logits.weight'], W[T + 'to_logits.bias'], lowp)


def forward(W, cfg, context, seqs, block_len, lowp=None, kv_layers=()):
    """Logits of the last ``block_len`` positions of each sequence: each of
    ``seqs`` is (B, N, in_dim) image tokens (whole blocks, the last one the
    block being denoised) after the shared prompt ``context`` (B, M,
    context_dim).  Returns ``(logits, kv)``: logits a list (B, block_len,
    V) per sequence; ``kv[i]`` the (k, v) of every position of each
    sequence at layer i, for i in ``kv_layers``."""
    m = context.shape[1]
    ctx = prompt_in(W, context, lowp)
    xs = [torch.cat([ctx, tokens_in(W, t, lowp)], dim=1) for t in seqs]
    blocks = [block_ids(m, t.shape[1], block_len, context.device)
              for t in seqs]
    kv = {}
    for i in range(cfg['depth']):
        xs, kvs = layer(W, cfg, i, xs, blocks, lowp)
        if i in kv_layers:
            kv[i] = kvs
    return [head(W, cfg, x[:, -block_len:], lowp) for x in xs], kv
