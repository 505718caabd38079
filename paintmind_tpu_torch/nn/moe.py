"""Mixture-of-Experts SwiGLU (``paintmind_tpu/nn/moe.py``): the stage-2
block's feed-forward replaced by a routed pool of ``E`` SwiGLU experts.

Routing is GShard / Switch style with static shapes:

  * the router, a bias-free linear map to ``E`` logits, runs in fp32
    whatever the activations' type; each token takes its top ``k`` experts
    (ties go to the lower index, as ``jax.lax.top_k``), with the top-k
    softmax gates renormalised to sum to 1;
  * every expert holds ``C = max(1, int(T·k/E·cf + 0.999))`` slots, ``T``
    the call's token count (so the capacity, and with it every token's
    routing, depends on the whole batch); with no capacity factor
    (``None``: dropless, as SDAR-30B-A3B routes) ``C = T``, room for every
    token, so nothing is dropped and a token's routing is its own;
  * queue positions are slot-major (every token's first choice is queued
    before any token's second choice, tokens in (b, l) order); a
    (token, slot) assignment past its expert's capacity is dropped, and
    contributes 0 (the block's residual carries the token through);
  * the auxiliary losses: the Switch load-balance loss ``E·Σ_e f_e·p_e``
    over the top-1 dispatch fractions ``f_e`` and mean router probabilities
    ``p_e`` (1 at perfect balance), the router z-loss
    ``mean(logsumexp(logits)²)``, the dropped fraction and the per-expert
    top-1 load ``f_e``.

Placement.  Expert parallelism (``tp``, set by ``parallel.mesh``): the
experts' E axis is carved over 'model' (this rank holds E/tp of them), the
router stays whole.  Every rank of a model group holds the same tokens, so
no all-to-all is needed: each routes all of them, runs its own experts on
their slots, and the combine is an all-reduce.  ``'auto'`` dispatch is then
``'dense'``, as the JAX package's ``_auto_dispatch`` picks it for a mesh
that shards the experts.  Data parallelism (``route_group``, the 'data'
group, set by the trainers): JAX routes the global batch, so capacity,
slot order and the routing statistics come from every data shard's tokens;
here each rank all-gathers the (k, E) assignment counts of the others to
place its own assignments in the global slot order, and the statistics are
summed over the group.

The experts are stacked: ``experts.w12`` and ``experts.w3`` are
``StackedLinear`` layers with weight (E, out, in) and bias (E, out).  The
JAX package computes dispatch, experts and combine with XLA, outside any
Pallas kernel.  Here a call takes one of two paths, by what it can see:

  * packed (``ops/moe_experts.py``, kernel K5): the kept assignments packed
    by expert, the experts run on those rows alone with the SwiGLU in the
    first product's epilogue, and a combine that reads only the kept rows.
    Taken by ``'gather'`` when nothing records a gradient, with no expert
    or data parallelism, for bf16 tokens on the card (the kernels) or any
    on the CPU (their plain version);
  * padded (``_padded``, one function for every placement): this rank's
    experts on an (E, C, D) buffer of their slots, one batched product
    pair.  Everything else: ``'dense'``, training (K5 has no backward),
    expert or data parallelism, fp32 and fp16 on the card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import moe_experts as K5
from ..parallel import collectives as C
from ..parallel.tensor_parallel import enter
from ..utils import profiling
from ..utils.profiling import annotate

from .attention import Attention
from .core import LayerNorm, Linear
from .mlp import swiglu_hidden_dim
from .transformer import _remat_block

DISPATCHES = ('auto', 'gather', 'dense')


class StackedLinear(nn.Module):
    """``num`` linear maps of one shape: weight (num, out, in), bias
    (num, out), or none with ``bias=False``.  ``forward`` maps (num, C, in)
    -> (num, C, out), the i-th map on the i-th slice, in the input's
    type."""

    def __init__(self, num, in_features, out_features, *, bias=True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(num, out_features, in_features,
                                               **kw))
        self.bias = (nn.Parameter(torch.empty(num, out_features, **kw))
                     if bias else None)

    @torch.no_grad()
    def init_weights_(self, generator):
        """Xavier-uniform per map (the JAX package vmaps its initialiser
        over the experts), zero biases."""
        out_f, in_f = self.weight.shape[1:]
        a = math.sqrt(6.0 / (in_f + out_f))
        self.weight.uniform_(-a, a, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        w = self.weight.to(x.dtype).transpose(1, 2)
        if self.bias is None:
            return torch.bmm(x, w)
        return torch.baddbmm(self.bias.to(x.dtype)[:, None, :], x, w)


class StackedSwiGLU(nn.Module):
    """``E`` SwiGLU experts (``nn/mlp.py``'s layout, stacked); ``hidden``
    their width where it is given directly (SDAR's 768), else by the 2/3
    rule from ``mlp_dim``."""

    def __init__(self, num, dim, mlp_dim, *, hidden=None, bias=True,
                 device=None, dtype=None):
        super().__init__()
        hidden = hidden or swiglu_hidden_dim(mlp_dim)
        kw = dict(bias=bias, device=device, dtype=dtype)
        self.w12 = StackedLinear(num, dim, 2 * hidden, **kw)
        self.w3 = StackedLinear(num, hidden, dim, **kw)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class MoESwiGLU(nn.Module):
    """``router`` (bias-free ``Linear(dim, E)``) and ``experts``
    (``StackedSwiGLU``: ``expert_hidden`` wide where given, with biases
    unless ``expert_bias=False``); ``forward(x) -> (y, aux)`` is
    ``moe_swiglu`` with the routing options given here
    (``capacity_factor=None``: dropless).  ``stats=False``: a caller that
    reads no routing statistics (SDAR's sampling stack) gets ``aux`` None
    and the call forms none of them."""

    def __init__(self, dim, mlp_dim, num_experts, *, num_selected=2,
                 capacity_factor=1.25, dispatch='auto', expert_hidden=None,
                 expert_bias=True, stats=True, device=None, dtype=None):
        super().__init__()
        self.router = Linear(dim, num_experts, bias=False, device=device,
                             dtype=dtype)
        self.experts = StackedSwiGLU(num_experts, dim, mlp_dim,
                                     hidden=expert_hidden, bias=expert_bias,
                                     device=device, dtype=dtype)
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.dispatch = dispatch
        self.stats = stats
        self.tp = None            # expert parallelism over 'model'
        self.route_group = None   # data parallelism: route the global batch

    def forward(self, x):
        return moe_swiglu(self, x, self.num_selected, self.capacity_factor,
                          self.dispatch)


def capacity(tokens, k, num_experts, capacity_factor):
    """Slots per expert: the JAX package's expression, float and all; with
    no capacity factor (dropless) every token: a token takes an expert at
    most once."""
    if capacity_factor is None:
        return tokens
    return max(1, int(tokens * k / num_experts * capacity_factor + 0.999))


def route(module, xt, num_selected, capacity_factor, group=None):
    """The routing of (T, D) tokens: ``(logits, probs, gate, idx, pos,
    keep, cap)``.  ``logits`` / ``probs`` (T, E) fp32; ``gate`` (T, k) the
    renormalised top-k probabilities, ``idx`` (T, k) their experts (a stable
    descending sort: ties go to the lower index); ``pos`` (T, k) each
    assignment's place in its expert's queue, slot-major; ``keep`` (T, k)
    ``pos < cap`` and a positive gate.  ``group``: the data-parallel group
    whose ranks' tokens (in rank order after this rank's) form the global
    batch the capacity and the queue positions count."""
    e = module.num_experts
    k = min(num_selected, e)
    t = xt.shape[0]
    ranks = 1 if group is None else dist.get_world_size(group)
    logits = module.router(xt.float())
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt.values[:, :k], srt.indices[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(t * ranks, k, e, capacity_factor)
    # slot-major queue: the k·T assignments in (slot, token) order, each
    # placed after the earlier ones to its expert.  The one-hot is (E, k·T)
    # so that the scan runs along the inner axis: down the outer axis of a
    # (k·T, E) tensor the card's scan is some 3 ms at T = 8192.
    experts = torch.arange(e, device=idx.device)[:, None]
    flat = (experts == idx.t().reshape(1, -1)).int()       # (E, k·T)
    before = flat.cumsum(1, dtype=torch.int32) - flat
    pos = (before * flat).sum(0).reshape(k, t).t()         # (T, k) int64
    if group is not None:
        pos = pos + _global_offsets(flat, idx, k, t, e, group)
    keep = (pos < cap) & (gate > 0)
    return logits, probs, gate, idx, pos, keep, cap


def _global_offsets(flat, idx, k, t, e, group):
    """Per assignment, the number of assignments to its expert that come
    before this rank's in the global slot-major order but not on this rank:
    the other ranks' in earlier slots, and the earlier ranks' in its own."""
    counts = flat.reshape(e, k, t).sum(-1).t().contiguous()   # (k, E)
    every = C.all_gather(counts[None], group, 0)              # (R, k, E)
    r = dist.get_rank(group)
    total = every.sum(0)
    others_earlier = (total.cumsum(0) - total) - (counts.cumsum(0) - counts)
    off = others_earlier + every[:r].sum(0)                   # (k, E)
    return torch.gather(off, 1, idx.t()).t()


def moe_swiglu(module, x, num_selected=2, capacity_factor=1.25,
               dispatch='auto'):
    """x: (..., D) -> (y (..., D), aux).  ``aux``: ``lb_loss``,
    ``router_z``, ``dropped`` (0-d fp32) and ``expert_load`` ((E,) fp32).

    ``dispatch``: ``'gather'`` takes the packed path where the call allows
    it (K5: the module's docstring), else the padded core ``_padded`` in its
    indexed form; ``'dense'`` takes ``_padded`` in its one-hot einsum form.
    The forms give the same routing and the same result up to rounding.
    ``'auto'`` is ``'dense'`` when the experts are carved over a model axis
    of more than one rank and ``'gather'`` otherwise (the JAX package's
    ``_auto_dispatch``)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f'dispatch {dispatch!r} not in {DISPATCHES}')
    tp = module.tp
    if dispatch == 'auto':
        dispatch = 'dense' if tp is not None and tp.size > 1 else 'gather'
    packed = dispatch == 'gather' and _packed(module, x)
    with annotate('pm.moe'):
        if tp is not None and tp.sequence:  # whole sequence, as in the blocks
            x = enter(x, tp)
        lead, d = x.shape[:-1], x.shape[-1]
        xt = x.reshape(-1, d)
        e, group = module.num_experts, module.route_group
        with annotate('pm.moe.route'):
            logits, probs, gate, idx, pos, keep, cap = route(
                module, xt, num_selected, capacity_factor, group)
            dt = x.dtype
            gk = gate.to(dt) * keep.to(dt)                      # (T, k)
        profiling.count('pm.moe.assignments', keep.numel())
        profiling.count('pm.moe.kept', keep)
        if packed:
            with annotate('pm.moe.dispatch'):
                off, row, xp = K5.dispatch(xt.contiguous(), idx, pos, keep, cap,
                                           e)
            profiling.count('pm.moe.grouped', 1)
            profiling.count('pm.moe.rows', off[-1])
            if profiling.counting():  # the experts with a row: a device sum
                profiling.count('pm.moe.experts_hit', off[1:] > off[:-1])
            with annotate('pm.moe.experts'):
                w12, w3 = module.experts.w12, module.experts.w3
                out = K5.grouped_swiglu(xp, off, w12.weight.to(dt),
                                        _to(w12.bias, dt), w3.weight.to(dt),
                                        _to(w3.bias, dt))
            with annotate('pm.moe.combine'):
                y = K5.combine(out, row, gk)
        else:
            y = _padded(module, xt, idx, pos, keep, gk, cap, dispatch, tp)

        if tp is not None and tp.sequence:
            y = C.local_slice(y.reshape(*lead, -1), tp.group, 1)
            lead = y.shape[:-1]
        aux = None
        if module.stats:
            with annotate('pm.moe.aux'):
                aux = _aux(logits, probs, idx, keep, e, group)
        return y.reshape(*lead, y.shape[-1]), aux


def _to(bias, dtype):
    return None if bias is None else bias.to(dtype)


def _packed(module, x):
    """Whether a ``'gather'`` call takes the packed path (the module's
    docstring): no gradient recorded, no expert or data parallelism, and
    bf16 tokens on the card or any tokens on the CPU."""
    if module.tp is not None or module.route_group is not None:
        return False
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in module.parameters())):
        return False
    return x.device.type == 'cpu' or (x.device.type == 'cuda'
                                      and x.dtype == torch.bfloat16)


def _aux(logits, probs, idx, keep, e, group):
    """The routing statistics; under data parallelism over the global batch
    (each rank adds the same replicated values into its loss, so the sums
    carry their gradient back summed too, ``sum_replicated``)."""
    if group is None:
        frac = F.one_hot(idx[:, 0], e).float().mean(0)      # top-1 f_e
        return {
            'lb_loss': e * (frac * probs.mean(0)).sum(),
            'router_z': (torch.logsumexp(logits, dim=-1) ** 2).mean(),
            'dropped': 1.0 - keep.float().mean(),
            'expert_load': frac,
        }
    t = idx.shape[0] * dist.get_world_size(group)
    with torch.no_grad():
        counts = torch.cat([F.one_hot(idx[:, 0], e).float().sum(0),
                            keep.float().sum().reshape(1)])
        C.all_reduce(counts, group)
    frac = counts[:e] / t
    stats = C.sum_replicated(torch.cat([
        probs.sum(0), (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]]),
        group)
    return {
        'lb_loss': e * (frac * (stats[:e] / t)).sum(),
        'router_z': stats[e] / t,
        'dropped': 1.0 - counts[e] / (t * idx.shape[1]),
        'expert_load': frac,
    }


def _padded(module, xt, idx, pos, keep, gk, cap, dispatch, tp):
    """The padded path: this rank's ``El`` experts (all ``E`` without expert
    parallelism) on an (El, C, D) buffer of their slots, run as one batched
    product pair.  ``'gather'`` writes each kept assignment's token into its
    own (expert, queue) cell of an (El·C + 1, D) buffer by an indexed
    assignment (the cells are unique, so no atomics and the same bits every
    run; dropped assignments and other ranks' experts all land in the spare
    last row, which is cut off) and gathers the outputs back (the spare row
    reads 0); ``'dense'`` is the one-hot (T, El, C) einsum form.  Under
    expert parallelism the replicated tokens and gates enter through
    ``copy_to`` (their gradients from the local experts are summed over the
    ranks) and the combine is summed over 'model'."""
    e, (t, d), k = module.num_experts, xt.shape, idx.shape[1]
    el = module.experts.w12.weight.shape[0]                  # local experts
    lo, dt, x_in, g_in = 0, xt.dtype, xt, gk
    if tp is not None:
        lo = tp.rank * el
        if not tp.sequence:
            x_in, g_in = C.copy_to(xt, tp.group), C.copy_to(gk, tp.group)
    with annotate('pm.moe.dispatch'):
        if dispatch == 'dense':
            pos_oh = F.one_hot(torch.where(keep, pos, cap),
                               cap + 1)[..., :cap]
            sel = F.one_hot(idx, e).to(dt)[..., lo:lo + el]  # (T, k, El)
            pos_oh = pos_oh.to(dt)                           # (T, k, C)
            disp = torch.einsum('tke,tkc->tec', sel * keep[..., None].to(dt),
                                pos_oh)
            comb = torch.einsum('tke,tkc->tec', g_in[..., None] * sel,
                                pos_oh)
            expert_in = torch.einsum('tec,td->ecd', disp, x_in)
        else:
            mine = keep & (idx >= lo) & (idx < lo + el)
            cell = torch.where(mine, (idx - lo) * cap + pos,
                               el * cap).reshape(-1)
            x_rep = x_in[:, None, :].expand(t, k, d).reshape(t * k, d)
            buf = torch.index_put(x_in.new_zeros(el * cap + 1, d), (cell,),
                                  x_rep)
            expert_in = buf[:-1].view(el, cap, d)
    with annotate('pm.moe.experts'):
        expert_out = module.experts(expert_in)               # (El, C, Do)
    with annotate('pm.moe.combine'):
        if dispatch == 'dense':
            y = torch.einsum('tec,ecd->td', comb, expert_out)
        else:
            out = F.pad(expert_out.reshape(el * cap, -1), (0, 0, 0, 1))
            picked = out[cell].view(t, k, -1)
            # one (1, k) x (k, Do) product a token: the k terms accumulate
            # in fp32 and round once, as in the dense form's product
            y = torch.bmm(g_in[:, None, :], picked)[:, 0]
        if tp is not None:
            y = (C.all_reduce if tp.sequence else C.reduce_from)(y, tp.group)
    return y


class MoEBlock(nn.Module):
    """The stage-2 block (``nn/transformer.py::Block`` with cross-attention)
    with the SwiGLU routed: ``forward`` returns ``(x, aux)``.  Attention
    dropout in training mode from the caller's generator, as in ``Block``."""

    def __init__(self, dim, *, dim_head, mlp_dim, num_head, num_experts,
                 num_selected=2, capacity_factor=1.25, dispatch='auto',
                 context_dim=None, dropout=0.0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        attn = dict(heads=num_head, dim_head=dim_head, dropout=dropout, **kw)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, **attn)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, context_dim=context_dim, **attn)
        self.norm3 = LayerNorm(dim, **kw)
        self.ffnet = MoESwiGLU(dim, mlp_dim, num_experts,
                               num_selected=num_selected,
                               capacity_factor=capacity_factor,
                               dispatch=dispatch, **kw)

    def forward(self, x, context=None, *, backend=None, generator=None):
        x = x + self.attn1(self.norm1(x), backend=backend, generator=generator)
        x = x + self.attn2(self.norm2(x), context, backend=backend,
                           generator=generator)
        h, aux = self.ffnet(self.norm3(x))
        return x + h, aux


def make_moe_stack(depth, dim, **kw):
    return nn.ModuleList(MoEBlock(dim, **kw) for _ in range(depth))


def moe_stack_apply(layers, x, context=None, *, backend=None, generator=None,
                    remat=False):
    """Run the blocks; returns ``(x, aux)`` with each aux value summed over
    the layers and divided by the depth (loss weights independent of
    depth).  ``remat``: each block under ``torch.utils.checkpoint``."""
    total = None
    for block in layers:
        if remat:
            x, aux = _remat_block(block, x, context, generator,
                                  backend=backend)
        else:
            x, aux = block(x, context, backend=backend, generator=generator)
        total = aux if total is None else {n: total[n] + aux[n] for n in aux}
    return x, {n: v / len(layers) for n, v in total.items()}
