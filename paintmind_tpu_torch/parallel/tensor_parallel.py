"""The tensor-parallel forms the layers switch to when a placement carves
them (``parallel/mesh.shard_params`` sets their ``tp``).

A block's sublayer under tensor parallelism: the (replicated) input enters
through ``enter`` (``copy_to``: its gradient is summed over 'model'), the
column-parallel products run on this rank's heads or features, and the
row-parallel output product ``row_linear`` sums the ranks' partial outputs
with one all-reduce, its bias added once after it.  LayerNorm and the
residual stay replicated.  Under sequence parallelism the hidden state
between sublayers holds this rank's slice of the sequence: ``enter``
all-gathers it and ``row_linear`` reduce-scatters the output instead.

On a one-rank group every collective is the identity, and ``row_linear``
then keeps the unplaced layer's own product (bias folded in), so a
placement at world size 1 computes the unplaced bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.quant import QLinear, int8_matmul
from . import collectives as C


def enter(x, tp):
    """A sublayer's input: gathered along the sequence (sequence parallel)
    or passed on with its gradient summed over 'model'."""
    if tp.sequence:
        return C.gather_seq(x, tp.group, 1)
    return C.copy_to(x, tp.group)


def _reduce(y, tp):
    if tp.sequence:
        return C.scatter_seq(y, tp.group, 1)
    return C.reduce_from(y, tp.group)


def row_linear(mod, x, tp):
    """A row-parallel ``Linear`` or ``QLinear`` on this rank's input
    features: the partial products summed over 'model', the bias once.

    int8 ``w8a8`` keeps the unplaced layer's global arithmetic: the
    per-token scale comes from the abs-max over **all** input features (an
    all-reduce MAX), and the int32 accumulators are summed exactly before
    the one rescale; a carved ``w8a8`` linear so equals the unplaced one bit
    for bit wherever the int32 sums do."""
    if not isinstance(mod, QLinear):
        if tp.size == 1:
            return _reduce(mod(x), tp)
        y = _reduce(F.linear(x, mod.weight.to(x.dtype)), tp)
        return y if mod.bias is None else y + mod.bias.to(x.dtype)
    dt = x.dtype
    if mod.mode == 'w8a8':
        x32 = x.float()
        amax = x32.abs().amax(dim=-1, keepdim=True)
        C.all_reduce(amax, tp.group, torch.distributed.ReduceOp.MAX)
        sx = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
        xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), mod.kernel_q)
        acc = acc.reshape(*x.shape[:-1], mod.kernel_q.shape[0])
        if tp.sequence:
            acc = C.reduce_scatter(acc, tp.group, 1)
            sx = C.local_slice(sx, tp.group, 1)
        else:
            C.all_reduce(acc, tp.group)
        y = (acc.float() * sx * mod.scale.float()).to(dt)
    else:
        y = _reduce(F.linear(x, mod.kernel_q.to(dt)), tp) * mod.scale.to(dt)
    if mod.bias is not None:
        y = y + mod.bias.to(dt)
    return y


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.local_slice(x, group, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g, ctx.group, 1), None


def split_seq(x, tp):
    """This rank's slice of a replicated (B, N, D) hidden state."""
    if tp.size > 1 and x.shape[1] % tp.size:
        raise ValueError(f'sequence parallelism: {x.shape[1]} tokens do not '
                         f'divide over model={tp.size}')
    if torch.is_grad_enabled() and x.requires_grad:
        return _SplitSeq.apply(x, tp.group)
    return C.local_slice(x, tp.group, 1).contiguous()


def gather_seq(x, tp):
    """The whole sequence back from the ranks' slices, replicated."""
    return C.gather_split(x, tp.group, 1)


def vocab_logits(head, h, tp):
    """The column-parallel vocab head: this rank's vocab slice, all-gathered
    so that the sampler (K3) sees whole rows."""
    return C.gather_split(head(C.copy_to(h, tp.group)), tp.group, -1)
