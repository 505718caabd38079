"""Counted collectives and their autograd forms.

Every collective of the port goes through this module, so ``counts`` (a
dict keyed ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``send_recv``, ``broadcast``) says how many of each a run made, as the
kernel wrappers' launch counters say how many kernels ran.  A collective
over a one-rank group is the identity, as XLA compiles a collective over a
one-device axis away: it is counted, and also in ``elided``, but not
issued (no ``torch.distributed`` call), and its result is the input itself
(``all_reduce``, ``reduce_scatter``, ``all_gather``, the broadcast) or the
one-element list (``all_gather_object``).

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
elided = dict.fromkeys(KINDS, 0)  # of ``counts``: those over one rank


def reset_counts():
    for k in KINDS:
        counts[k] = 0
        elided[k] = 0


def snapshot():
    return dict(counts)


def _size(group):
    return dist.get_world_size(group)


def _rank(group):
    return dist.get_rank(group)


def _count(kind, group):
    """Count one ``kind`` over ``group``; True when it must be issued (more
    than one rank)."""
    counts[kind] += 1
    if _size(group) > 1:
        return True
    elided[kind] += 1
    return False


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """In place; returns ``t``."""
    if _count('all_reduce', group):
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, group, dim=0):
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    if not _count('all_gather', group):
        return t
    n = _size(group)
    src = t.contiguous()
    out = src.new_empty(n * src.numel())
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', FutureWarning)
        dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    out = out.view((n,) + src.shape)
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter(t, group, dim=0):
    """The sum over ranks of ``t``, of which each rank keeps its slice
    along ``dim`` (rank order)."""
    if not _count('reduce_scatter', group):
        return t
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
    if not _count('broadcast', group):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_object(obj, group=None):
    if not _count('all_gather', group):
        return [obj]
    out = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def send_recv(sends=(), recvs=()):
    """Point-to-point hops in one ``batch_isend_irecv``: ``sends`` and
    ``recvs`` are (tensor, global peer rank) pairs; waits for all.  A
    one-stage pipeline makes none (GPipe sends only between stages)."""
    ops = ([dist.P2POp(dist.isend, t.contiguous(), p) for t, p in sends]
           + [dist.P2POp(dist.irecv, t, p) for t, p in recvs])
    if not ops:
        return
    counts['send_recv'] += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def local_slice(t, group, dim):
    """This rank's contiguous slice of ``t`` along ``dim`` (``t`` itself
    over one rank)."""
    n, r = _size(group), _rank(group)
    if n == 1:
        return t
    step = t.shape[dim] // n
    return t.narrow(dim, r * step, step)


def _own(t, group):
    """A contiguous copy of ``t`` for an in-place collective to overwrite;
    ``t`` itself over one rank, where the collective is the identity."""
    if _size(group) == 1:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_own(g, ctx.group), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(_own(x, group), group)

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
        return all_reduce(_own(x, group), group)

    @staticmethod
    def backward(ctx, g):
        return _SumReplicated.apply(g, ctx.group), None


# Where no gradient can flow (a decode under ``torch.no_grad``), each pair
# is its forward alone: the same collective, without an autograd node.

def _grad(x):
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x, group):
    return _CopyTo.apply(x, group) if _grad(x) else x


def reduce_from(x, group):
    if _grad(x):
        return _ReduceFrom.apply(x, group)
    return all_reduce(_own(x, group), group)


def gather_seq(x, group, dim=1):
    return _GatherSeq.apply(x, group, dim) if _grad(x) else \
        all_gather(x, group, dim)


def scatter_seq(x, group, dim=1):
    return _ScatterSeq.apply(x, group, dim) if _grad(x) else \
        reduce_scatter(x, group, dim)


def gather_split(x, group, dim=-1):
    return _GatherSplit.apply(x, group, dim % x.ndim) if _grad(x) else \
        all_gather(x, group, dim % x.ndim)


def sum_replicated(x, group):
    if _grad(x):
        return _SumReplicated.apply(x, group)
    return all_reduce(_own(x, group), group)
