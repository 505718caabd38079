"""Pre-LN transformer blocks (``paintmind_tpu/nn/transformer.py``).

  * stage-1 block: ``x = attn1(norm1(x)) + x; x = ffnet(norm2(x)) + x``
  * stage-2 block: self-attention, cross-attention to the context (which
    self-attends when the context is None), SwiGLU.

The JAX package stacks the layers' weights along a leading depth axis and
scans one block over them; here a stack is an ``nn.ModuleList`` run by a
Python loop (``convert/from_jax`` unstacks the weights).

Training: a block in training mode applies dropout after each attention's
output projection, with masks drawn from the caller's generator.
``remat=True`` wraps each block in ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint`` of the scan body): the backward pass runs the
block's forward again instead of keeping its activations.
"""

from __future__ import annotations

from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention
from .core import LayerNorm
from .mlp import SwiGLU


class Block(nn.Module):
    def __init__(self, dim, *, dim_head, mlp_dim, num_head, cross=False,
                 context_dim=None, dropout=0.0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        attn = dict(heads=num_head, dim_head=dim_head, dropout=dropout, **kw)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, **attn)
        self.norm2 = LayerNorm(dim, **kw)
        self.ffnet = SwiGLU(dim, mlp_dim, **kw)
        self.cross = cross
        if cross:
            self.attn2 = Attention(dim, context_dim=context_dim, **attn)
            self.norm3 = LayerNorm(dim, **kw)

    def forward(self, x, context=None, *, backend=None, cfg_halves=False,
                generator=None):
        x = x + self.attn1(self.norm1(x), backend=backend, generator=generator)
        if not self.cross:
            return x + self.ffnet(self.norm2(x))
        if cfg_halves and context is not None:
            # x is a [cond; uncond] 2B batch; see forward_cfg_halves
            x = x + self.attn2.forward_cfg_halves(self.norm2(x), context,
                                                  backend=backend)
        else:
            x = x + self.attn2(self.norm2(x), context, backend=backend,
                               generator=generator)
        return x + self.ffnet(self.norm3(x))


def make_stack(depth, dim, **kw):
    return nn.ModuleList(Block(dim, **kw) for _ in range(depth))


def _remat_block(block, x, context, generator, **kw):
    """``block(x, context)`` under ``torch.utils.checkpoint``.  The
    recomputation must draw the dropout masks of the first run.
    ``preserve_rng_state`` covers torch's default generators only, so for an
    explicit generator its state is noted here, outside the checkpointed
    function; the recomputation rewinds to it and afterwards puts the
    generator back where the backward pass found it."""
    draws = block.training and generator is not None
    start = generator.get_state() if draws else None
    first_run = [True]

    def run(x, context):
        if not draws or first_run[0]:
            first_run[0] = False
            return block(x, context, generator=generator, **kw)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, context, generator=generator, **kw)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, context, use_reentrant=False,
                      preserve_rng_state=block.training and generator is None)


def stack_apply(layers, x, context=None, *, backend=None, cfg_halves=False,
                generator=None, remat=False):
    for block in layers:
        if remat:
            x = _remat_block(block, x, context, generator, backend=backend,
                             cfg_halves=cfg_halves)
        else:
            x = block(x, context, backend=backend, cfg_halves=cfg_halves,
                      generator=generator)
    return x
