"""Plain reference of the flan-T5 encoder (T5 v1.1: Raffel et al. 2020 and
the v1.1 changes; Hugging Face ``T5EncoderModel``): RMS pre-norm, a
bidirectional relative-position bucket bias from the first layer's table
added in every layer, no 1/sqrt(d) attention scale, a gated feed-forward
with tanh-approximated GELU, a final RMS norm.  Every token position is
attended (no padding mask), as the PaintMind reference passes only the
ids.  Weights are the flat dict ``weights.make_tower`` makes.  Imports
nothing but torch."""

import math

import torch
import torch.nn.functional as F


def bucket(rel, num_buckets=32, max_distance=128):
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(n.float().clamp_min(1) / exact)
                     / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return out + torch.where(n < exact, n, large)


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def lin(x, w, lowp=None):
    w = w.float()
    if lowp == 'tf32':
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return x @ w.t()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return x @ w.t()


def encode(W, cfg, ids, lowp=None):
    """(B, L) ids -> (B, L, d_model) fp32 last hidden state."""
    x = W['embed.weight'].float()[ids]
    l = ids.shape[1]
    pos = torch.arange(l, device=ids.device)
    b = bucket(pos[None, :] - pos[:, None], cfg['rel_buckets'],
               cfg['rel_max_distance'])
    bias = W['rel_bias.weight'].float()[b].permute(2, 0, 1)[None]
    h_, dk, eps = cfg['num_heads'], cfg['d_kv'], cfg['eps']
    for i in range(cfg['num_layers']):
        p = f'blocks.{i}.'
        h = rms(x, W[p + 'ln0.weight'], eps)
        q, k, v = (lin(h, W[p + n + '.weight'], lowp).unflatten(-1, (h_, dk))
                   .transpose(1, 2) for n in ('q', 'k', 'v'))
        a = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1) @ v
        x = x + lin(a.transpose(1, 2).flatten(-2), W[p + 'o.weight'], lowp)
        h = rms(x, W[p + 'ln1.weight'], eps)
        g = F.gelu(lin(h, W[p + 'wi_0.weight'], lowp), approximate='tanh')
        x = x + lin(g * lin(h, W[p + 'wi_1.weight'], lowp), W[p + 'wo.weight'],
                    lowp)
    return rms(x, W['final_ln.weight'], eps)
