"""Counted collectives and their autograd forms.

Every collective of the port goes through this module, so ``counts`` (a
dict keyed ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``send_recv``, ``broadcast``) says how many of each a run made, as the
kernel wrappers' launch counters say how many kernels ran.  A collective
over a one-rank group is still made (and counted): it is the identity.

Tensors stay plain local tensors.  Where a gradient must pass through a
collective, the ``autograd.Function``s below carry it (megatron's pairs):

  * ``copy_to``: identity forward, all-reduce of the gradient backward (a
    replicated input entering column-parallel products);
  * ``reduce_from``: all-reduce forward, identity backward (the partial
    sums of row-parallel products);
  * ``gather_seq`` / ``scatter_seq``: all-gather along a dim forward and
    reduce-scatter backward, and the reverse (sequence parallelism);
  * ``gather_split``: all-gather along a dim forward, the rank's own slice
    of the gradient backward (a sharded result made replicated: the
    vocab-parallel logits, the sequence-parallel hidden state);
  * ``sum_replicated``: all-reduce forward and backward (a statistic every
    rank adds into the same replicated loss, e.g. the routing statistics
    of a data-parallel MoE).
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

KINDS = ('all_reduce', 'all_gather', 'reduce_scatter', 'send_recv',
         'broadcast')
counts = dict.fromkeys(KINDS, 0)


def reset_counts():
    for k in KINDS:
        counts[k] = 0


def snapshot():
    return dict(counts)


def _size(group):
    return dist.get_world_size(group)


def _rank(group):
    return dist.get_rank(group)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """In place; returns ``t``."""
    counts['all_reduce'] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, group, dim=0):
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    counts['all_gather'] += 1
    n = _size(group)
    src = t.contiguous()
    out = src.new_empty(n * src.numel())
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', FutureWarning)
        dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    out = out.view((n,) + src.shape)
    if n == 1:
        return out[0]
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter(t, group, dim=0):
    """The sum over ranks of ``t``, of which each rank keeps its slice
    along ``dim`` (rank order)."""
    counts['reduce_scatter'] += 1
    n = _size(group)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f'reduce_scatter: dim {dim} of {tuple(t.shape)} '
                         f'does not divide over {n} ranks')
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def broadcast_object(obj, src=0, group=None):
    counts['broadcast'] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_object(obj, group=None):
    counts['all_gather'] += 1
    out = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def send_recv(sends=(), recvs=()):
    """Point-to-point hops in one ``batch_isend_irecv``: ``sends`` and
    ``recvs`` are (tensor, global peer rank) pairs; waits for all."""
    ops = ([dist.P2POp(dist.isend, t.contiguous(), p) for t, p in sends]
           + [dist.P2POp(dist.irecv, t, p) for t, p in recvs])
    if not ops:
        return
    counts['send_recv'] += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def local_slice(t, group, dim):
    """This rank's contiguous slice of ``t`` along ``dim``."""
    n, r = _size(group), _rank(group)
    step = t.shape[dim] // n
    return t.narrow(dim, r * step, step)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _SumReplicated.apply(g, ctx.group), None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def gather_seq(x, group, dim=1):
    return _GatherSeq.apply(x, group, dim)


def scatter_seq(x, group, dim=1):
    return _ScatterSeq.apply(x, group, dim)


def gather_split(x, group, dim=-1):
    return _GatherSplit.apply(x, group, dim % x.ndim)


def sum_replicated(x, group):
    return _SumReplicated.apply(x, group)
