"""Plain reference of PaintMind's stage 2 and of the ViT-VQGAN decoder.

Plain PyTorch on whole tensors: no kernel, no cache, no batching tricks.
It reads the weights from the flat dict that ``benchmark/weights.py`` makes
(the parameter names of the published PaintMind layout) and computes in
float32 with TF32 off, or, for the control, with the operands of every
bf16 product of the configuration rounded to fp8 e4m3 (``lowp='fp8'``) or
int8 (``lowp='int8'``), scaled per row of activations and per output
channel of weights, the products accumulated in fp32.

The equations (Qiyuan-Ge/PaintMind ``paintmind/stage2/transformer.py`` and
``paintmind/stage1/vqgan.py``; the MoE variant's routing as documented in
the configuration file):

* block: ``x += attn1(LN1 x); x += attn2(LN2 x, context); x += ffn(LN3 x)``;
  with no context, ``attn2`` self-attends (the unconditional branch);
* attention: bias-free q/k/v, ``softmax(q k^T / sqrt(d_head)) v``, output
  projection with bias; SwiGLU: ``w3(silu(x1) * x2)`` with
  ``[x1 | x2] = w12 x``;
* the routed FFN: an fp32 router, top-k by a stable descending sort (ties
  to the lower expert), gates renormalised to sum to 1,
  ``C = max(1, int(T*k/E*cf + 0.999))`` slots an expert over the call's
  ``T`` tokens, slot-major queues (every token's first choice before any
  second choice), assignments past ``C`` dropped;
* classifier-free guidance ``u + s (c - u)`` on the logits;
* decoder: ``post_quant`` of the l2-normalised code rows, position table,
  blocks without cross-attention, LayerNorm, projection to 8x8x3 patches,
  clamp to [-1, 1].

This module imports nothing but torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fp32_mode():
    """Full fp32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def _q8(t, dim):
    """Symmetric int8 quantise-dequantise of ``t`` along ``dim``."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(t / s).clamp(-127, 127) * s


def _f8(t, dim):
    """fp8 (e4m3) quantise-dequantise of ``t``, scaled along ``dim`` so
    that its largest magnitude maps to 448 (the gradient passes straight
    through)."""
    s = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()


LOWP = {'int8': _q8, 'fp8': _f8}


def linear(x, w, b=None, lowp=None):
    w = w.float()
    if lowp is not None:
        x = LOWP[lowp](x, -1)
        w = LOWP[lowp](w, -1)
    y = x @ w.t()
    return y if b is None else y + b.float()


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), 1e-5)


def attention(W, p, x, ctx, heads, lowp=None, rows=4, keep=None, rate=0.0):
    """Multi-head attention of x (B, N, D) over ctx (B, M, Dc) (x itself
    when None), in blocks of ``rows`` batch rows.  ``keep``: the dropout
    keep-mask of the output (inverted dropout at ``rate``)."""
    ctx = x if ctx is None else ctx
    b, n, _ = x.shape
    q = linear(x, W[p + 'to_q.weight'], lowp=lowp)
    k = linear(ctx, W[p + 'to_k.weight'], lowp=lowp)
    v = linear(ctx, W[p + 'to_v.weight'], lowp=lowp)
    dh = q.shape[-1] // heads
    out = []
    for i in range(0, b, rows):
        qi = q[i:i + rows].unflatten(-1, (heads, dh)).transpose(1, 2)
        ki = k[i:i + rows].unflatten(-1, (heads, dh)).transpose(1, 2)
        vi = v[i:i + rows].unflatten(-1, (heads, dh)).transpose(1, 2)
        s = (qi @ ki.transpose(-1, -2)) * dh ** -0.5
        oi = torch.softmax(s, dim=-1) @ vi
        out.append(oi.transpose(1, 2).flatten(-2))
    out = linear(torch.cat(out), W[p + 'to_out.weight'], W[p + 'to_out.bias'],
                 lowp)
    if keep is not None:
        out = torch.where(keep, out / (1.0 - rate), torch.zeros_like(out))
    return out


def swiglu(x, w12, b12, w3, b3, lowp=None):
    h = linear(x, w12, b12, lowp)
    x1, x2 = h.chunk(2, dim=-1)
    return linear(F.silu(x1) * x2, w3, b3, lowp)


def capacity(tokens, k, num_experts, capacity_factor):
    return max(1, int(tokens * k / num_experts * capacity_factor + 0.999))


def routed_ffn(W, p, x, cfg, lowp=None):
    """The routed SwiGLU over every token of ``x`` (B, N, D) at once."""
    e, k, cf = cfg['num_experts'], cfg['num_selected'], cfg['capacity_factor']
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    t = xt.shape[0]
    probs = torch.softmax(xt @ W[p + 'router.weight'].float().t(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, :k], order.indices[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(t, k, e, cf)
    # queue positions in slot-major order: slot 0 of every token, then slot 1
    flat_idx = idx.t().reshape(-1)                            # (k*T,)
    onehot = F.one_hot(flat_idx, e)                           # (k*T, E)
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, flat_idx[:, None])
    pos = pos[:, 0].reshape(k, t).t()                         # (T, k)
    keep = (pos < cap) & (gate > 0)
    y = torch.zeros_like(xt)
    w12, b12 = W[p + 'experts.w12.weight'], W[p + 'experts.w12.bias']
    w3, b3 = W[p + 'experts.w3.weight'], W[p + 'experts.w3.bias']
    for ex in range(e):
        tok, slot = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(xt[tok], w12[ex], b12[ex], w3[ex], b3[ex], lowp)
        y.index_add_(0, tok, out * gate[tok, slot][:, None])
    return y.reshape(shape), 1.0 - keep.float().mean()


def embed(W, tokens, context, lowp=None):
    """The first block's input from latent tokens (B, L, in_dim), and the
    context (B, M, Dc) or None as the blocks read it."""
    p = 'transformer.'
    x = linear(tokens.float(), W[p + 'token_proj.weight'],
               W[p + 'token_proj.bias'], lowp) + W[p + 'pos_embed'].float()
    if context is not None:
        context = context.float()
        if p + 'context_proj.weight' in W:
            context = linear(context, W[p + 'context_proj.weight'], lowp=lowp)
    return x, context


def attend(W, cfg, i, x, context, lowp=None, keeps=None, rate=0.0):
    """``x`` after block ``i``'s two attention sub-layers; ``keeps`` an
    iterator over their dropout keep-masks, or None."""
    q = f'transformer.layers.{i}.'
    heads = cfg['num_head']
    x = x + attention(W, q + 'attn1.', layer_norm(
        x, W[q + 'norm1.weight'], W[q + 'norm1.bias']), None, heads, lowp,
        keep=next(keeps) if keeps else None, rate=rate)
    return x + attention(W, q + 'attn2.', layer_norm(
        x, W[q + 'norm2.weight'], W[q + 'norm2.bias']), context, heads,
        lowp, keep=next(keeps) if keeps else None, rate=rate)


def transformer(W, cfg, tokens, context, lowp=None, keeps=None,
                routed=routed_ffn):
    """Logits (B, L, V) in fp32 of the stage-2 transformer on latent tokens
    (B, L, in_dim); ``context`` (B, M, Dc) or None.  ``keeps``: in
    training, the dropout keep-masks of the attention outputs, in call order
    (attn1, attn2 of each layer).  ``routed``: the routed FFN, called as
    ``routed_ffn`` is."""
    keeps = iter(keeps) if keeps is not None else None
    rate = cfg['dropout'] if keeps is not None else 0.0
    p = 'transformer.'
    x, context = embed(W, tokens, context, lowp)
    for i in range(cfg['depth']):
        q = f'{p}layers.{i}.'
        x = attend(W, cfg, i, x, context, lowp, keeps, rate)
        h = layer_norm(x, W[q + 'norm3.weight'], W[q + 'norm3.bias'])
        if cfg.get('num_experts'):
            x = x + routed(W, q + 'ffnet.', h, cfg, lowp)[0]
        else:
            x = x + swiglu(h, W[q + 'ffnet.w12.weight'],
                           W[q + 'ffnet.w12.bias'], W[q + 'ffnet.w3.weight'],
                           W[q + 'ffnet.w3.bias'], lowp)
    x = layer_norm(x, W[p + 'norm.weight'], W[p + 'norm.bias'])
    return linear(x, W[p + 'to_logits.weight'], W[p + 'to_logits.bias'], lowp)


def guided_logits(W, cfg, tokens, context, scale, lowp=None,
                  routed=routed_ffn):
    """``u + s (c - u)``: the conditional pass on ``context``, the
    unconditional one with attn2 self-attending."""
    cond = transformer(W, cfg, tokens, context, lowp, routed=routed)
    if scale is None:
        return cond
    uncond = transformer(W, cfg, tokens, None, lowp, routed=routed)
    return uncond + scale * (cond - uncond)


def l2norm(x, eps=1e-12):
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def sampling_table(W):
    """Rows a latent token can hold while sampling: the raw codebook rows,
    then the mask token (its id is the codebook size)."""
    cb = W['vqgan.quantize.codebook'].float()
    return torch.cat([cb, W['mask_token'].float().reshape(1, -1)], 0)


def ids_of_rows(rows, table):
    """The id of each row of ``rows`` (..., D) in ``table`` (V, D): the
    nearest row, which is the row itself for a token gathered from it."""
    flat = rows.reshape(-1, rows.shape[-1]).float()
    d = (flat * flat).sum(-1, keepdim=True) - 2 * flat @ table.t() \
        + (table * table).sum(-1)[None]
    dist, ids = d.min(dim=-1)
    return ids.reshape(rows.shape[:-1]), dist.reshape(rows.shape[:-1])


def decode(W, s1, ids, lowp=None, rows=8):
    """Images (B, H, W, 3) in [-1, 1] from code ids (B, L)."""
    dec = s1['dec']
    z = l2norm(W['vqgan.quantize.codebook'])[ids]
    outs = []
    for i in range(0, ids.shape[0], rows):
        x = linear(z[i:i + rows], W['vqgan.post_quant.weight'],
                   W['vqgan.post_quant.bias'], lowp)
        p = 'vqgan.decoder.'
        x = x + W[p + 'pos_embed'].float()
        for j in range(dec['depth']):
            q = f'{p}layers.{j}.'
            x = x + attention(W, q + 'attn1.', layer_norm(
                x, W[q + 'norm1.weight'], W[q + 'norm1.bias']), None,
                dec['num_head'], lowp)
            x = x + swiglu(layer_norm(x, W[q + 'norm2.weight'],
                                      W[q + 'norm2.bias']),
                           W[q + 'ffnet.w12.weight'], W[q + 'ffnet.w12.bias'],
                           W[q + 'ffnet.w3.weight'], W[q + 'ffnet.w3.bias'],
                           lowp)
        x = linear(layer_norm(x, W[p + 'norm.weight'], W[p + 'norm.bias']),
                   W[p + 'proj.weight'], W[p + 'proj.bias'], lowp)
        patch, grid = dec['patch_size'], dec['image_size'] // dec['patch_size']
        b = x.shape[0]
        x = x.reshape(b, grid, grid, patch, patch, 3).permute(0, 1, 3, 2, 4, 5)
        outs.append(x.reshape(b, grid * patch, grid * patch, 3).clamp(-1, 1))
    return torch.cat(outs, 0)


def mask_counts(num_tokens, timesteps):
    """Masked positions left after each step of the cosine schedule."""
    out = []
    for t in range(1, timesteps + 1):
        r = math.cos(math.pi / 2.0 * t / timesteps)
        out.append(max(int(r * num_tokens), 1))
    return out


def encode_ids(W, s1, img, rows=8):
    """Code ids (B, L) of images (B, H, W, 3) in [-1, 1]: the ViT encoder,
    ``prev_quant``, l2-normalised, the nearest l2-normalised codebook row
    (the largest cosine)."""
    enc = s1['enc']
    p = 'vqgan.encoder.'
    codes = l2norm(W['vqgan.quantize.codebook'])
    out = []
    for i in range(0, img.shape[0], rows):
        x = img[i:i + rows].float()
        b, hh, ww, c = x.shape
        g = enc['patch_size']
        x = x.reshape(b, hh // g, g, ww // g, g, c).permute(0, 1, 3, 2, 4, 5)
        x = linear(x.reshape(b, -1, g * g * c), W[p + 'patch_embed.weight'])
        x = layer_norm(x + W[p + 'pos_embed'].float(), W[p + 'norm_pre.weight'],
                       W[p + 'norm_pre.bias'])
        for j in range(enc['depth']):
            q = f'{p}layers.{j}.'
            x = x + attention(W, q + 'attn1.', layer_norm(
                x, W[q + 'norm1.weight'], W[q + 'norm1.bias']), None,
                enc['num_head'])
            x = x + swiglu(layer_norm(x, W[q + 'norm2.weight'],
                                      W[q + 'norm2.bias']),
                           W[q + 'ffnet.w12.weight'], W[q + 'ffnet.w12.bias'],
                           W[q + 'ffnet.w3.weight'], W[q + 'ffnet.w3.bias'])
        z = l2norm(linear(x, W['vqgan.prev_quant.weight'],
                          W['vqgan.prev_quant.bias']))
        out.append((z @ codes.t()).argmax(-1))
    return torch.cat(out)


def masked_ce(logits, labels, mask, smoothing=0.1):
    """Cross-entropy with label smoothing summed over the masked positions
    (the caller divides by their count)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    per = (1.0 - smoothing) * nll - smoothing * logp.mean(-1)
    return (per * mask).sum()


def lion_update(params, grads, moments, lr, betas=(0.9, 0.99), wd=0.0):
    """One Lion update in optax's order (Chen et al. 2023):
    ``p -= lr (sign(b1 m + (1 - b1) g) + wd p)``, then
    ``m = b2 m + (1 - b2) g``."""
    b1, b2 = betas
    with torch.no_grad():
        for name, p in params.items():
            g, m = grads[name], moments[name]
            p.sub_(lr * (torch.sign(m * b1 + g * (1.0 - b1)) + wd * p))
            m.mul_(b2).add_(g, alpha=1.0 - b2)


def warmup_cosine(step, lr, lr_min, warmup, warmup_init, decay):
    """The published schedule (timm ``CosineLRScheduler`` with a warm-up
    prefix, stepped per update)."""
    if step < warmup:
        return warmup_init + step * (lr - warmup_init) / warmup
    t = step - warmup
    if t >= decay:
        return lr_min
    return lr_min + 0.5 * (lr - lr_min) * (1.0 + math.cos(math.pi * t / decay))
