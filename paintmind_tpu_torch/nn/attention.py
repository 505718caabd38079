"""Multi-head (self / cross) attention (``paintmind_tpu/nn/attention.py``).

q/k/v projections without bias, output projection with bias; with
``context=None`` the module self-attends (the unconditional branch of
classifier-free guidance).  The attention itself runs in the JAX layout
(B, N, H, D) through one of two backends:

  * ``'flash'`` / ``'auto'``: the K1 wrapper (``ops/flash_attention``), which
    launches the kernel on a CUDA tensor and takes the plain version on a
    CPU tensor.  When a gradient flows, the wrapper's ``autograd.Function``
    runs kernel K4 backward.  ``'auto'`` follows the JAX package's dispatch
    rule (``paintmind_tpu/nn/attention.py::_flash_ok``) on the head dim:
    head dims up to 128 go to the kernels, larger ones to the plain math,
    as JAX sends them to XLA.  Its other two conditions (N ≥ 128, M ≥ 16)
    are about the Pallas kernel's padding; K1 masks ragged edges itself and
    takes any N and M.
  * ``'plain'``: the plain PyTorch version on any device under ordinary
    autograd (the reference the kernel path is held against).

In training mode ``forward`` applies dropout to the output projection, from
an explicit generator; ``forward_cfg_halves`` is a sampling-only path and
stays deterministic, as in the JAX package.

``CachedAttention`` is SDAR-30B-A3B's (Qwen3-MoE's) self-attention for
block-diffusion decoding: grouped-query heads (``kv_heads`` KV heads, each
read by ``heads / kv_heads`` query heads), bias-free projections, an RMSNorm
over each head's q and k (QK-norm) before the rotary embedding, and a KV
cache: a pass over the tokens at positions [p, p + N) writes their
post-RoPE K/V into cache rows [p, p + N) and attends its N queries over
rows [0, p + N) of the cache, read in place (a strided view).  Blocks
passed in order are block-causal attention, bidirectional inside a block,
with no mask.

Tensor parallelism (``tp``, set by ``parallel.mesh.shard_params``): the
module holds this rank's heads (``heads`` is the local count, q/k/v
column-parallel), ``to_out`` is row-parallel and its partial outputs are
summed over 'model' (``parallel.tensor_parallel``).  ``tp=None`` is the
one-device path.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.flash_attention import flash_attention, flash_attention_plain
from ..parallel import collectives as C
from ..parallel.tensor_parallel import enter, row_linear
from ..ops.rope import norm_rope
from .core import Linear, RMSNorm
from .core import dropout as apply_dropout

BACKENDS = ('auto', 'plain', 'flash')
_backend = 'auto'


def set_attention_backend(name: str):
    """Globally select 'auto' | 'plain' | 'flash'."""
    if name not in BACKENDS:
        raise ValueError(f'attention backend {name!r} not in {BACKENDS}')
    global _backend
    _backend = name


def get_attention_backend() -> str:
    return _backend


# the JAX package's _flash_ok bound on the head dim: up to it the kernels
FLASH_MAX_HEAD_DIM = 128


def attention_core(q, k, v, scale, backend=None):
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D)."""
    backend = backend or _backend
    if backend not in BACKENDS:
        raise ValueError(f'attention backend {backend!r} not in {BACKENDS}')
    if backend == 'plain' or (backend == 'auto'
                              and q.shape[-1] > FLASH_MAX_HEAD_DIM):
        return flash_attention_plain(q, k, v, scale)
    return flash_attention(q, k, v, scale)


class Attention(nn.Module):
    def __init__(self, query_dim, *, context_dim=None, heads=8, dim_head=64,
                 dropout=0.0, device=None, dtype=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.dim_head = dim_head
        self.dropout = dropout
        kw = dict(device=device, dtype=dtype)
        self.to_q = Linear(query_dim, inner, bias=False, **kw)
        self.to_k = Linear(context_dim, inner, bias=False, **kw)
        self.to_v = Linear(context_dim, inner, bias=False, **kw)
        self.to_out = Linear(inner, query_dim, **kw)
        self.tp = None

    def _enter(self, x, context):
        """The (x, context) the projections read: as given, or under
        tensor parallelism passed into the column-parallel products (a
        sequence-sharded x gathered whole)."""
        if self.tp is None:
            return x, context
        x = enter(x, self.tp)
        return x, None if context is None else C.copy_to(context,
                                                         self.tp.group)

    def _out(self, out):
        if self.tp is None:
            return self.to_out(out)
        return row_linear(self.to_out, out, self.tp)

    def _split(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head)

    def forward(self, x, context=None, *, backend=None, generator=None):
        """x: (B, N, Dq); context: (B, M, Dc) or None (self-attention).
        ``generator`` feeds the dropout mask in training mode."""
        x, context = self._enter(x, context)
        ctx = x if context is None else context
        q = self._split(self.to_q(x))
        k = self._split(self.to_k(ctx))
        v = self._split(self.to_v(ctx))
        out = attention_core(q, k, v, self.dim_head ** -0.5, backend)
        out = self._out(out.reshape(x.shape[0], x.shape[1], -1))
        return apply_dropout(out, self.dropout, generator=generator,
                             training=self.training)

    def forward_cfg_halves(self, x, context, *, backend=None):
        """Cross-attention for a CFG-fused batch: ``x`` (2B, N, Dq) holds
        [conditional; unconditional] halves, ``context`` is (B, M, Dc).  The
        first B rows attend to ``context``, the last B self-attend; the Q and
        output projections run once at 2B."""
        x, context = self._enter(x, context)
        b = x.shape[0] // 2
        q = self._split(self.to_q(x))
        ctx = context.to(x.dtype)
        xu = x[b:]
        scale = self.dim_head ** -0.5
        out_c = attention_core(q[:b], self._split(self.to_k(ctx)),
                               self._split(self.to_v(ctx)), scale, backend)
        out_u = attention_core(q[b:], self._split(self.to_k(xu)),
                               self._split(self.to_v(xu)), scale, backend)
        out = torch.cat([out_c, out_u], dim=0)
        return self._out(out.reshape(x.shape[0], x.shape[1], -1))


class CachedAttention(nn.Module):
    """Grouped-query self-attention with QK-norm and rotary positions over a
    KV cache (the module's docstring): ``to_q`` (dim -> heads·dim_head),
    ``to_k`` and ``to_v`` (dim -> kv_heads·dim_head), ``to_out``, all
    without bias; ``q_norm`` and ``k_norm`` RMSNorms over dim_head,
    applied in the rotary embedding's fp32 pass
    (``ops/rope.norm_rope``, kernel K6 on the card, which writes k into the
    cache in place)."""

    def __init__(self, dim, *, heads, kv_heads, dim_head, eps=1e-6,
                 device=None, dtype=None):
        super().__init__()
        if heads % kv_heads:
            raise ValueError(f'{heads} query heads over {kv_heads} KV heads')
        kw = dict(device=device, dtype=dtype)
        self.heads, self.kv_heads, self.dim_head = heads, kv_heads, dim_head
        self.to_q = Linear(dim, heads * dim_head, bias=False, **kw)
        self.to_k = Linear(dim, kv_heads * dim_head, bias=False, **kw)
        self.to_v = Linear(dim, kv_heads * dim_head, bias=False, **kw)
        self.to_out = Linear(heads * dim_head, dim, bias=False, **kw)
        self.q_norm = RMSNorm(dim_head, eps, **kw)
        self.k_norm = RMSNorm(dim_head, eps, **kw)

    def forward(self, x, cache, start, rope, *, backend=None):
        """x (B, N, dim) at positions [start, start + N); ``cache`` (k, v),
        each (B, L, kv_heads, dim_head), receives their K/V in rows
        [start, start + N); ``rope`` the (cos, sin) tables of those
        positions, each (N, dim_head).  Returns (B, N, dim)."""
        b, n, _ = x.shape
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        k = self.to_k(x).reshape(b, n, self.kv_heads, self.dim_head)
        v = self.to_v(x).reshape(b, n, self.kv_heads, self.dim_head)
        cos, sin = rope
        q = norm_rope(q, cos, sin, self.q_norm.weight, self.q_norm.eps)
        k_cache, v_cache = cache
        end = start + n
        norm_rope(k, cos, sin, self.k_norm.weight, self.k_norm.eps,
                  out=k_cache[:, start:end])
        v_cache[:, start:end] = v
        out = attention_core(q, k_cache[:, :end], v_cache[:, :end],
                             self.dim_head ** -0.5, backend)
        return self.to_out(out.reshape(b, n, -1))
