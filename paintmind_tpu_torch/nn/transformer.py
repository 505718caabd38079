"""Pre-LN transformer blocks (``paintmind_tpu/nn/transformer.py``).

  * stage-1 block: ``x = attn1(norm1(x)) + x; x = ffnet(norm2(x)) + x``
  * stage-2 block: self-attention, cross-attention to the context (which
    self-attends when the context is None), SwiGLU.

The JAX package stacks the layers' weights along a leading depth axis and
scans one block over them; here a stack is an ``nn.ModuleList`` run by a
Python loop (``convert/from_jax`` unstacks the weights).
"""

from __future__ import annotations

from torch import nn

from .attention import Attention
from .core import LayerNorm
from .mlp import SwiGLU


class Block(nn.Module):
    def __init__(self, dim, *, dim_head, mlp_dim, num_head, cross=False,
                 context_dim=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, heads=num_head, dim_head=dim_head, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.ffnet = SwiGLU(dim, mlp_dim, **kw)
        self.cross = cross
        if cross:
            self.attn2 = Attention(dim, context_dim=context_dim,
                                   heads=num_head, dim_head=dim_head, **kw)
            self.norm3 = LayerNorm(dim, **kw)

    def forward(self, x, context=None, *, backend=None, cfg_halves=False):
        x = x + self.attn1(self.norm1(x), backend=backend)
        if not self.cross:
            return x + self.ffnet(self.norm2(x))
        if cfg_halves and context is not None:
            # x is a [cond; uncond] 2B batch; see forward_cfg_halves
            x = x + self.attn2.forward_cfg_halves(self.norm2(x), context,
                                                  backend=backend)
        else:
            x = x + self.attn2(self.norm2(x), context, backend=backend)
        return x + self.ffnet(self.norm3(x))


def make_stack(depth, dim, **kw):
    return nn.ModuleList(Block(dim, **kw) for _ in range(depth))


def stack_apply(layers, x, context=None, *, backend=None, cfg_halves=False):
    for block in layers:
        x = block(x, context, backend=backend, cfg_halves=cfg_halves)
    return x
