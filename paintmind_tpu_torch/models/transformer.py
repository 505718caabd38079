"""Stage-2 conditional bidirectional transformer, the MaskGIT backbone
(``paintmind_tpu/models/transformer.py``): token_proj (32 -> dim) ->
learned pos-embed -> depth x {self-attn, cross-attn(context), SwiGLU} ->
LN -> to_logits (dim -> n_embed).  ``context_proj`` exists only when
context_dim != dim.  With ``context=None`` the cross-attention sublayers
self-attend: the unconditional branch of classifier-free guidance.  In
training mode the attention sublayers apply dropout at ``cfg.dropout``.

Under a placement (``parallel.mesh.shard_params`` sets ``tp``) the vocab
head is column-parallel and its logits are all-gathered, so the sampler
sees whole rows; with sequence parallelism the blocks run on this rank's
slice of the sequence, gathered back after the final LayerNorm."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.core import LayerNorm, Linear, init_module_
from ..nn.transformer import make_stack, stack_apply
from ..parallel.tensor_parallel import gather_seq, split_seq, vocab_logits


@dataclasses.dataclass(frozen=True)
class CondTransformerConfig:
    in_dim: int = 32
    dim: int = 1024
    len_seq: int = 1024
    dim_head: int = 64
    mlp_dim: int = 4096
    num_head: int = 16
    depth: int = 12
    dropout: float = 0.1
    context_dim: int = 1024
    num_classes: int = 8192

    @property
    def has_context_proj(self):
        return self.context_dim != self.dim


class CondTransformer(nn.Module):
    def __init__(self, cfg: CondTransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_proj = Linear(cfg.in_dim, cfg.dim, **kw)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.len_seq, cfg.dim,
                                                  **kw))
        self.layers = self._make_layers(cfg, **kw)
        self.norm = LayerNorm(cfg.dim, **kw)
        self.to_logits = Linear(cfg.dim, cfg.num_classes, **kw)
        if cfg.has_context_proj:
            self.context_proj = Linear(cfg.context_dim, cfg.dim, bias=False,
                                       **kw)
        self.tp = None

    @staticmethod
    def _make_layers(cfg, **kw):
        return make_stack(cfg.depth, cfg.dim, dim_head=cfg.dim_head,
                          mlp_dim=cfg.mlp_dim, num_head=cfg.num_head,
                          cross=True, context_dim=cfg.dim,
                          dropout=cfg.dropout, **kw)

    @torch.no_grad()
    def init_weights_(self, generator):
        init_module_(self, generator)
        self.pos_embed.normal_(generator=generator).mul_(self.cfg.dim ** -0.5)

    def head_project(self, h):
        """Vocab projection of a post-LN hidden state, in its dtype."""
        if self.tp is None:
            return self.to_logits(h)
        return vocab_logits(self.to_logits, h, self.tp)

    def _seq_split(self, x):
        seq = self.tp is not None and self.tp.sequence
        return split_seq(x, self.tp) if seq else x

    def _seq_gather(self, x):
        seq = self.tp is not None and self.tp.sequence
        return gather_seq(x, self.tp) if seq else x

    def embed(self, x, context):
        """``token_proj`` and the position table on the tokens; the context
        in their type, through ``context_proj`` where there is one."""
        x = self.token_proj(x)
        x = x + self.pos_embed.to(x.dtype)
        if context is not None:
            context = context.to(x.dtype)
            if self.cfg.has_context_proj:
                context = self.context_proj(context)
        return x, context

    def forward(self, x, context=None, *, backend=None, cfg_halves=False,
                return_hidden=False, generator=None, remat=False):
        """x: (B, len_seq, in_dim) latent tokens; context (B, M, context_dim)
        or None.  Returns (B, len_seq, num_classes) logits, or the post-LN
        hidden state when ``return_hidden``.  ``cfg_halves``: x is a
        [cond; uncond] 2B batch and context is (B, M, context_dim).
        ``generator``: source of the dropout masks in training mode.
        ``remat``: recompute each block in the backward pass instead of
        keeping its activations."""
        x, context = self.embed(x, context)
        x = stack_apply(self.layers, self._seq_split(x), context,
                        backend=backend, cfg_halves=cfg_halves,
                        generator=generator, remat=remat)
        x = self._seq_gather(self.norm(x))
        return x if return_hidden else self.head_project(x)
