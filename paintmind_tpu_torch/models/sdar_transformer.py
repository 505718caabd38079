"""SDAR-30B-A3B's decoder stack as a stage-2 transformer (no counterpart in
the JAX package): block diffusion over the image codes, with a KV cache.

SDAR (JetLM, ``SDAR-30B-A3B-Chat``, ``config.json``: ``model_type``
``sdar_moe``) is a Qwen3-MoE decoder trained to denoise blocks of tokens
left to right: inside a block attention is bidirectional, across blocks it
is causal, and finished blocks live in a KV cache.  Its layer:

    x = x + o(attn(rope(q_norm(q(rms1 x))), rope(k_norm(k(rms1 x))), v(rms1 x)))
    x = x + moe(rms2 x)

with RMSNorms (eps 1e-6, statistics in fp32), grouped-query attention (32
query heads of 128 over 4 KV heads, no biases), QK-norm (an RMSNorm over
each head's 128 dims of q and k) before the rotary embedding (rotate-half,
theta 1e6), and every layer routed: 128 bias-free SwiGLU experts of width
768, the top 8 by an fp32 softmax router with the gates renormalised, no
shared expert and no capacity (dropless).  48 layers of width 2048.

The stage-2 image stack replaces SDAR's 151936-token text embedding and head
by the pipeline's own: ``token_proj`` of the 32-wide VQGAN code vectors in,
``to_logits`` over the 8192 codes out (both with bias, as in the MaskGIT
stack), and the prompt is the (B, M, t5_dim) context through
``context_proj``, the sequence's first block at positions [0, M); image
block j covers the positions [M + j·block_len, M + (j + 1)·block_len).

``prefill`` runs the prompt into the cache; ``forward`` runs one block of
tokens at a position, writing its K/V into the cache and returning its
logits (or nothing: the commit pass).  ``models/pipeline.generate_blocks``
drives them over a cache from ``cache``, made once for a batch shape and
kept for later calls of that shape.

On the card the layer stack of a pass is a CUDA graph, one for each
position a pass starts at (the prompt's, each block's: the steps and the
commit pass of a block replay the same graph), captured right after its
first eager run and replayed after: a pass is some 12 000 launches of
small host work (routing, dispatch, norms, the kernels' wrappers) against
~80 ms of device work at B = 64, and run eagerly the host's speed, which
varies with what else its cores run, paced the card.  The embedding, the
final norm and the head stay eager, so hooks on the transformer and on
``to_logits`` still see every pass.  A traced run replays the same graphs:
the spans inside the stack (``pm.moe.*``) do not record in a graph, the
spans around a pass (``pm.prefill``, ``pm.step.logits``,
``pm.block.commit``) time its replay; the counters the capture counted
(``profiling.tally``: ``pm.attn.*`` on the host, ``pm.moe.rows`` and
``pm.moe.experts_hit`` summed by kernels of the graph) and the kernels'
launch counters are added again at each replay.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.attention import CachedAttention
from ..nn.core import Linear, RMSNorm, init_module_, rope_tables
from ..nn.moe import MoESwiGLU, StackedLinear
from ..ops import flash_attention as fa
from ..ops import moe_experts as me
from ..ops import rope as rope_ops
from ..utils import profiling

# the launch counters of the kernels the stack runs (K1, K5, K6)
_LAUNCHES = ((fa, 'launches'), (me, 'launches'), (rope_ops, 'launches'))


@dataclasses.dataclass(frozen=True)
class SDARTransformerConfig:
    in_dim: int = 32
    dim: int = 2048
    len_seq: int = 1024          # image tokens
    dim_head: int = 128
    num_head: int = 32
    kv_heads: int = 4
    depth: int = 48
    num_experts: int = 128
    num_selected: int = 8
    expert_hidden: int = 768
    capacity_factor: float | None = None   # None: dropless
    moe_dispatch: str = 'auto'
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    context_dim: int = 1024
    num_classes: int = 8192


class SDARBlock(nn.Module):
    """One decoder layer: RMSNorm, cached GQA attention, RMSNorm, the
    routed FFN."""

    def __init__(self, cfg: SDARTransformerConfig, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(cfg.dim, cfg.rms_eps, **kw)
        self.attn = CachedAttention(cfg.dim, heads=cfg.num_head,
                                    kv_heads=cfg.kv_heads,
                                    dim_head=cfg.dim_head, eps=cfg.rms_eps,
                                    **kw)
        self.norm2 = RMSNorm(cfg.dim, cfg.rms_eps, **kw)
        self.ffnet = MoESwiGLU(cfg.dim, None, cfg.num_experts,
                               num_selected=cfg.num_selected,
                               capacity_factor=cfg.capacity_factor,
                               dispatch=cfg.moe_dispatch,
                               expert_hidden=cfg.expert_hidden,
                               expert_bias=False, stats=False, **kw)

    def forward(self, x, cache, start, rope, *, backend=None):
        x = x + self.attn(self.norm1(x), cache, start, rope, backend=backend)
        h, _ = self.ffnet(self.norm2(x))
        return x + h


class SDARTransformer(nn.Module):
    def __init__(self, cfg: SDARTransformerConfig, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_proj = Linear(cfg.in_dim, cfg.dim, **kw)
        self.context_proj = Linear(cfg.context_dim, cfg.dim, bias=False, **kw)
        self.layers = nn.ModuleList(SDARBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps, **kw)
        self.to_logits = Linear(cfg.dim, cfg.num_classes, **kw)
        self._tables = {}   # (length, device) -> rope tables
        self._caches = {}   # (batch, length, dtype, device) -> KV cache
        self._graphs = {}   # (cache, start, shape) -> (graph, input, output)
        self._pool = None

    @torch.no_grad()
    def init_weights_(self, generator):
        """Xavier-uniform linears and experts, zero biases, unit norms."""
        init_module_(self, generator)
        for m in self.modules():
            if isinstance(m, StackedLinear):
                m.init_weights_(generator)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)

    def cache(self, batch, length, *, dtype, device):
        """The KV cache of ``length`` positions for a batch of ``batch``:
        per layer a (k, v) pair, each (batch, length, kv_heads, dim_head),
        made at the first call of this shape and the same tensors after
        (a call's passes overwrite every row they read)."""
        key = (batch, length, dtype, torch.device(device))
        if key not in self._caches:
            cfg = self.cfg
            shape = (batch, length, cfg.kv_heads, cfg.dim_head)
            self._caches[key] = [
                (torch.empty(shape, dtype=dtype, device=device),
                 torch.empty(shape, dtype=dtype, device=device))
                for _ in range(cfg.depth)]
        return self._caches[key]

    def rope(self, start, n, length, device):
        """(cos, sin) of positions [start, start + n), each (n, dim_head)
        fp32: slices of tables made once for a cache of ``length``
        positions."""
        key = (length, torch.device(device))
        if key not in self._tables:
            self._tables[key] = rope_tables(range(length), self.cfg.dim_head,
                                            self.cfg.rope_theta, device=device)
        cos, sin = self._tables[key]
        return cos[start:start + n], sin[start:start + n]

    def _layers(self, x, cache, start, backend):
        rope = self.rope(start, x.shape[1], cache[0][0].shape[1], x.device)
        for layer, kv in zip(self.layers, cache):
            x = layer(x, kv, start, rope, backend=backend)
        return x

    def _run(self, x, cache, start, backend):
        """The layer stack over x at ``start``: eagerly off the card, over
        a cache not made by ``cache``, or at a position's first pass (then
        captured); else the position's graph, replayed, and what its
        capture counted counted again (the module's docstring)."""
        held = next((k for k, c in self._caches.items() if c is cache), None)
        if x.device.type != 'cuda' or backend is not None or held is None:
            return self._layers(x, cache, start, backend)
        key = (held, start, tuple(x.shape), x.dtype)
        if key not in self._graphs:
            out = self._layers(x, cache, start, backend)
            self._capture(key, x, cache, start, backend)
            return out
        graph, static_in, static_out, counts, launches = self._graphs[key]
        static_in.copy_(x)
        graph.replay()
        for (mod, attr), n in zip(_LAUNCHES, launches):
            setattr(mod, attr, getattr(mod, attr) + n)
        profiling.recount(counts)
        return static_out

    def _capture(self, key, x, cache, start, backend):
        """The graph of the stack's pass at ``key``, with the counts and
        the launches its capture made (taken off the launch counters: a
        capture runs nothing)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_in = torch.empty_like(x)
        before = [getattr(mod, attr) for mod, attr in _LAUNCHES]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            with profiling.tally() as counts:
                static_out = self._layers(static_in, cache, start, backend)
        launches = []
        for (mod, attr), n in zip(_LAUNCHES, before):
            launches.append(getattr(mod, attr) - n)
            setattr(mod, attr, n)
        self._graphs[key] = (graph, static_in, static_out, counts, launches)

    def prefill(self, context, cache, *, backend=None):
        """The prompt block: ``context`` (B, M, context_dim) through
        ``context_proj`` and the stack at positions [0, M), its K/V into
        the cache."""
        self._run(self.context_proj(context), cache, 0, backend)

    def forward(self, tokens, cache, start, *, logits=True, backend=None):
        """tokens (B, N, in_dim) at positions [start, start + N) over the
        cache's rows below ``start``; their K/V go into the cache.  Returns
        the (B, N, num_classes) logits, or None when ``logits`` is False
        (the commit pass, which only writes the block's K/V)."""
        x = self._run(self.token_proj(tokens), cache, start, backend)
        return self.to_logits(self.norm(x)) if logits else None
