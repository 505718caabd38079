"""GPipe pipeline parallelism over the mesh 'model' axis
(``paintmind_tpu/parallel/pipeline_parallel.py``).

The stage-2 layer stack is cut by depth: stage s of S (the s-th rank of a
'model' group) holds layers [s·depth/S, (s+1)·depth/S).  ``shard_for_pp``
drops the other stages' layers from a rank's transformer, keeping each
held layer under its global index (``layers.{i}``), so state dicts name
the same tensors under any placement.

The schedule (``_GPipe``): the rank's batch is cut into M microbatches;
stage s runs microbatch m after stage s−1 has sent it on (M + S − 1 ticks
end to end, stage s running microbatch t − s at tick t); stage S−1's
outputs are made replicated by an all-reduce of the last stage's rows (the
other stages add zeros, JAX's masked ``psum``).  The embedding and the head
run outside, replicated; the conditioning context of a microbatch is the
same on every stage (each stage slices its own copy, so only activations
travel).

The backward.  JAX transposes ``ppermute`` for free; here the schedule is
one ``torch.autograd.Function`` that keeps each microbatch's graph and, in
its backward, walks the microbatches in the forward's order: the last stage
starts from the replicated output's gradient, every other stage receives
its output's gradient from stage s+1, runs its graph back and sends its
input's gradient to stage s−1.  Every rank posts its hops in that one
order, so no two wait on each other.  The hops are
``batch_isend_irecv`` (``collectives.send_recv``).

Parameters used before the pipeline (the embedding, the context
projection, the mask token) receive their gradient on the stages that use
their output: stage 0 for the tokens, every stage for the context.  The
trainers sum those gradients over the pipe group (``pp_input_params``);
the head's gradients are the same on every stage.

MoE stacks (``pp_moe_stack_apply``): a microbatch routes on its own
tokens (capacity from the microbatch), as inside JAX's ``shard_map``; the
aux values are averaged over stages × microbatches (each stage's already a
mean over its layers), then over the data group.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from . import collectives as C
from .mesh import DATA_AXIS, MODEL_AXIS


@dataclasses.dataclass(eq=False)
class PPInfo:
    group: object
    stages: int
    stage: int
    microbatches: int
    mesh: object


class StageLayers(nn.ModuleDict):
    """A stage's slice of a layer stack, keyed by global layer index;
    iterates its blocks in depth order, as an ``nn.ModuleList`` does."""
    pp_local = True

    def __iter__(self):
        return iter(self.values())


def pp_depth(layers):
    """The depth of a (full) layer stack."""
    return len(layers)


def pp_stack_spec(depth, stages):
    """Stage placement of a depth-``depth`` stack over ``stages`` stages:
    {layer index: the stage that holds it} (stage s holds layers
    [s·depth/S, (s+1)·depth/S))."""
    if depth % stages:
        raise ValueError(f'depth {depth} must be divisible by {stages} '
                         'pipeline stages')
    per = depth // stages
    return {i: i // per for i in range(depth)}


def _stages(mesh, pipe_axis):
    return mesh.size(pipe_axis), mesh.rank(pipe_axis), mesh.group(pipe_axis)


def _stage_layers(layers, stages, stage):
    if getattr(layers, 'pp_local', False):
        return layers
    spec = pp_stack_spec(pp_depth(layers), stages)
    return [block for i, block in enumerate(layers) if spec[i] == stage]


def _peer(group, offset):
    """Global rank of the stage ``offset`` away in ``group``."""
    ranks = dist.get_process_group_ranks(group)
    return ranks[dist.get_rank(group) + offset]


class _Schedule:
    """One GPipe call: the forward's graphs, kept for its backward."""

    def __init__(self, stage_fn, group, stages, stage, microbatches, aux_keys,
                 keep_graph):
        self.stage_fn = stage_fn
        self.group, self.stages, self.stage = group, stages, stage
        self.m = microbatches
        self.aux_keys = aux_keys
        self.keep_graph = keep_graph
        self.saved = []

    def forward(self, x, context):
        s, last = self.stage, self.stages - 1
        xs = x.chunk(self.m)
        cs = context.chunk(self.m) if context is not None else [None] * self.m
        outs, sums = [], {k: 0.0 for k in self.aux_keys}
        for m in range(self.m):
            inp = xs[m]
            if s > 0:
                inp = torch.empty_like(xs[m])
                C.send_recv(recvs=[(inp, _peer(self.group, -1))])
            ctx = cs[m]
            if self.keep_graph:
                inp = inp.detach().requires_grad_(s > 0 or x.requires_grad)
                if ctx is not None:
                    ctx = ctx.detach().requires_grad_(context.requires_grad)
                with torch.enable_grad():
                    out, aux = self.stage_fn(inp, ctx, m)
                self.saved.append((inp, ctx, out, aux))
            else:
                out, aux = self.stage_fn(inp, ctx, m)
            for k in self.aux_keys:
                sums[k] = sums[k] + aux[k].detach().float()
            if s < last:
                C.send_recv(sends=[(out.detach(), _peer(self.group, 1))])
            else:
                outs.append(out.detach())
        full = torch.cat(outs) if s == last else torch.zeros_like(x)
        C.all_reduce(full, self.group)
        aux = []
        for k in self.aux_keys:
            v = torch.as_tensor(sums[k], dtype=torch.float32,
                                device=x.device).clone()
            aux.append(C.all_reduce(v, self.group) / (self.stages * self.m))
        return (full, *aux)

    def backward(self, g_out, g_aux):
        s, last = self.stage, self.stages - 1
        g_outs = g_out.chunk(self.m)
        gx, gc = [], []
        scale = 1.0 / (self.stages * self.m)
        for m in range(self.m):
            inp, ctx, out, aux = self.saved[m]
            if s == last:
                g = g_outs[m].contiguous()
            else:
                g = torch.empty_like(out)
                C.send_recv(recvs=[(g, _peer(self.group, 1))])
            tensors, grads = [out], [g]
            for k, ga in zip(self.aux_keys, g_aux):
                if ga is not None and aux[k].requires_grad:
                    tensors.append(aux[k])
                    grads.append((ga * scale).to(aux[k].dtype))
            torch.autograd.backward(tensors, grads)
            if s > 0:
                C.send_recv(sends=[(inp.grad, _peer(self.group, -1))])
            else:
                gx.append(inp.grad)
            gc.append(None if ctx is None else ctx.grad)
        self.saved = []
        gx = (torch.cat(gx) if gx and all(g is not None for g in gx)
              else None)
        gc = (torch.cat(gc) if gc and all(g is not None for g in gc)
              else None)
        return gx, gc


class _GPipe(torch.autograd.Function):
    """``anchor``: an empty tensor that requires grad when the stage's
    parameters do, so that the schedule's backward runs even when neither
    input does (the stage's gradients land in its parameters)."""

    @staticmethod
    def forward(ctx, run, anchor, x, context):
        ctx.run = run
        return run.forward(x, context)

    @staticmethod
    def backward(ctx, g_out, *g_aux):
        gx, gc = ctx.run.backward(g_out, g_aux)
        return None, None, gx, gc


def _stage_generator(generator, microbatch, stage, seed):
    """Dropout masks per (microbatch, stage) from the caller's draw."""
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    return g.manual_seed((seed + 1000003 * microbatch + 7919 * stage)
                         % (2 ** 63))


def _gpipe_schedule(layers, x, context, *, mesh, microbatches, stage_fn,
                    aux_keys=(), generator=None, pipe_axis=MODEL_AXIS,
                    data_axis=DATA_AXIS):
    """Shared machinery of ``pp_stack_apply`` and ``pp_moe_stack_apply``.
    ``stage_fn(stage_layers, x, ctx, generator) -> (out, aux dict)``."""
    stages, stage, group = _stages(mesh, pipe_axis)
    local = _stage_layers(layers, stages, stage)
    dp = mesh.size(data_axis)
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f'batch {b * dp} must be divisible by dp={dp} × '
                         f'microbatches={microbatches}')
    seed = 0
    if generator is not None:
        seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device))

    def run_stage(inp, ctx, m):
        return stage_fn(local, inp, ctx,
                        _stage_generator(generator, m, stage, seed))

    grad = torch.is_grad_enabled() and any(
        p.requires_grad for block in local for p in block.parameters())
    run = _Schedule(run_stage, group, stages, stage, microbatches,
                    tuple(aux_keys), torch.is_grad_enabled())
    anchor = torch.empty(0, device=x.device, requires_grad=grad)
    outs = _GPipe.apply(run, anchor, x, context)
    if not aux_keys:
        return outs[0] if isinstance(outs, tuple) else outs
    out, *aux = outs
    aux = dict(zip(aux_keys, aux))
    if dp > 1:
        dgroup = mesh.group(data_axis)
        aux = {k: C.sum_replicated(v, dgroup) / dp for k, v in aux.items()}
    return out, aux


def pp_stack_apply(layers, x, context=None, *, mesh, microbatches,
                   backend=None, generator=None, remat=False,
                   pipe_axis=MODEL_AXIS, data_axis=DATA_AXIS):
    """Drop-in pipelined alternative to ``nn.transformer.stack_apply``.
    ``layers``: the full stack (this rank's stage is cut from it; depth must
    divide the stages) or a stage's ``StageLayers``.  ``x``: (b, N, D), this
    data rank's rows; b must divide into the microbatches.  ``context``:
    (b, M, Dc) or None.  Returns (b, N, D) on every stage."""
    from ..nn.transformer import stack_apply

    def stage_fn(local, inp, ctx, gen):
        return stack_apply(local, inp, ctx, backend=backend, generator=gen,
                           remat=remat), {}

    return _gpipe_schedule(layers, x, context, mesh=mesh,
                           microbatches=microbatches, stage_fn=stage_fn,
                           generator=generator, pipe_axis=pipe_axis,
                           data_axis=data_axis)


MOE_AUX = ('lb_loss', 'router_z', 'dropped', 'expert_load')


def pp_moe_stack_apply(layers, x, context=None, *, mesh, microbatches,
                       backend=None, generator=None, remat=False,
                       pipe_axis=MODEL_AXIS, data_axis=DATA_AXIS):
    """Pipelined ``nn.moe.moe_stack_apply``: returns (x, aux); each
    microbatch routes on its own tokens."""
    from ..nn.moe import moe_stack_apply

    def stage_fn(local, inp, ctx, gen):
        return moe_stack_apply(local, inp, ctx, backend=backend,
                               generator=gen, remat=remat)

    return _gpipe_schedule(layers, x, context, mesh=mesh,
                           microbatches=microbatches, stage_fn=stage_fn,
                           aux_keys=MOE_AUX, generator=generator,
                           pipe_axis=pipe_axis, data_axis=data_axis)


def pp_cond_transformer_param_spec(transformer, stages):
    """The stage placement of an unstaged transformer: {parameter name:
    the stage that holds it, or None for the replicated embedding and
    head}."""
    spec = pp_stack_spec(pp_depth(transformer.layers), stages)
    return {name: spec[int(name.split('.')[1])]
            if name.startswith('layers.') else None
            for name, _ in transformer.named_parameters()}


def _dropout_generator(transformer, generator):
    """The caller's generator where the stack draws dropout masks, else
    None (so that a run without dropout draws nothing from it)."""
    if transformer.training and transformer.cfg.dropout > 0:
        return generator
    return None


def pp_cond_transformer_apply(transformer, x, context=None, *, mesh,
                              microbatches, backend=None, generator=None,
                              remat=False, return_hidden=False,
                              pipe_axis=MODEL_AXIS, data_axis=DATA_AXIS):
    """Pipelined ``CondTransformer.forward``: embedding and the final LN /
    vocab head replicated, the stack through the schedule.
    ``return_hidden``: the post-LN hidden state (the CFG sampler mixes the
    branches' hiddens before the shared head)."""
    from ..models.moe_transformer import MoECondTransformer
    if isinstance(transformer, MoECondTransformer):
        raise TypeError('pp_cond_transformer_apply got an MoE transformer — '
                        'use pp_moe_cond_transformer_apply (returns '
                        '(logits, aux))')
    x, context = transformer.embed(x, context)
    x = pp_stack_apply(transformer.layers, x, context, mesh=mesh,
                       microbatches=microbatches, backend=backend,
                       generator=_dropout_generator(transformer, generator),
                       remat=remat, pipe_axis=pipe_axis, data_axis=data_axis)
    x = transformer.norm(x)
    return x if return_hidden else transformer.head_project(x)


def pp_moe_cond_transformer_apply(transformer, x, context=None, *, mesh,
                                  microbatches, backend=None, generator=None,
                                  remat=False, return_hidden=False,
                                  pipe_axis=MODEL_AXIS, data_axis=DATA_AXIS):
    """Pipelined ``MoECondTransformer.forward``: (logits, aux), or
    (post-LN hidden, aux) with ``return_hidden``."""
    x, context = transformer.embed(x, context)
    x, aux = pp_moe_stack_apply(transformer.layers, x, context, mesh=mesh,
                                microbatches=microbatches, backend=backend,
                                generator=_dropout_generator(transformer,
                                                             generator),
                                remat=remat,
                                pipe_axis=pipe_axis, data_axis=data_axis)
    x = transformer.norm(x)
    return (x if return_hidden else transformer.head_project(x)), aux


def transformer_apply_for(transformer, mesh, microbatches):
    """The pipelined apply for ``transformer`` (dense or MoE), with the
    signature of ``transformer(x, context, backend=, generator=, remat=)``."""
    from ..models.moe_transformer import MoECondTransformer
    fn = (pp_moe_cond_transformer_apply
          if isinstance(transformer, MoECondTransformer)
          else pp_cond_transformer_apply)

    def apply(tr, x, context=None, *, backend=None, generator=None,
              remat=False, return_hidden=False):
        return fn(tr, x, context, mesh=mesh, microbatches=microbatches,
                  backend=backend, generator=generator, remat=remat,
                  return_hidden=return_hidden)

    return apply


@torch.no_grad()
def shard_for_pp(transformer, mesh, microbatches=2, pipe_axis=MODEL_AXIS):
    """Keep only this rank's stage of ``transformer.layers`` (under their
    global indices); the embedding and the head stay replicated.  Returns
    the transformer."""
    stages, stage, group = _stages(mesh, pipe_axis)
    if getattr(transformer, '_pp', None) is not None:
        raise RuntimeError('the transformer is already staged')
    spec = pp_stack_spec(pp_depth(transformer.layers), stages)
    held = StageLayers({str(i): transformer.layers[i]
                        for i, s in spec.items() if s == stage})
    transformer.layers = held
    for p in held.parameters():
        p._pm_axes = (pipe_axis,)
    transformer._pp = PPInfo(group, stages, stage, int(microbatches), mesh)
    return transformer


@torch.no_grad()
def unstage_for_pp(transformer):
    """The inverse of ``shard_for_pp``: the other stages' layers gathered
    over the pipe group (every stage calls it), ``transformer.layers`` the
    whole stack again (an ``nn.ModuleList`` in depth order) and ``_pp``
    cleared.  A stage's layers are whole blocks of one type, so a missing
    one is a copy of a held one that loads the gathered weights.  The
    identity on an unstaged transformer.  Returns the transformer."""
    pp = getattr(transformer, '_pp', None)
    if pp is None:
        return transformer
    held = transformer.layers
    template = next(iter(held.values()))
    device = next(template.parameters()).device
    parts = {}
    for part in C.all_gather_object(
            {int(i): block.state_dict() for i, block in held.items()},
            pp.group):
        parts.update(part)
    blocks = []
    for i in sorted(parts):
        if str(i) in held:
            blocks.append(held[str(i)])
            continue
        block = copy.deepcopy(template)
        block.load_state_dict({k: v.to(device) for k, v in parts[i].items()})
        blocks.append(block)
    transformer.layers = nn.ModuleList(blocks)
    for p in transformer.layers.parameters():
        vars(p).pop('_pm_axes', None)
    transformer._pp = None
    return transformer


def pp_input_params(pipe):
    """The parameters whose gradients the stages hold in parts (used before
    the pipeline): summed over the pipe group after the backward."""
    tr = pipe.transformer
    out = [pipe.mask_token, *tr.token_proj.parameters(), tr.pos_embed]
    if hasattr(tr, 'context_proj'):
        out += list(tr.context_proj.parameters())
    return out


def merge_stages(module, sd):
    """``sd`` with every staged stack's layers gathered from the other
    stages of its pipe group (the identity without a staged stack)."""
    for name, mod in module.named_modules():
        pp = getattr(mod, '_pp', None)
        if pp is None:
            continue
        p = (name + '.' if name else '') + 'layers.'
        keys = list(sd)
        at = next(i for i, k in enumerate(keys) if k.startswith(p))
        mine = {k: sd[k] for k in keys if k.startswith(p)}
        device = next(iter(mine.values())).device
        layers = {}
        for part in C.all_gather_object(mine, pp.group):
            layers.update({k: v.to(device) for k, v in part.items()})
        # layer by layer in depth order, each in the module's own order
        order = sorted(layers, key=lambda k: int(k[len(p):].split('.', 1)[0]))
        rest = [k for k in keys if not k.startswith(p)]
        sd = {**{k: sd[k] for k in rest[:at]},
              **{k: layers[k] for k in order},
              **{k: sd[k] for k in rest[at:]}}
    return sd
