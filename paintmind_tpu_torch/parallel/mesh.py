"""The (data, model) mesh and the placement rules
(``paintmind_tpu/parallel/mesh.py``).

``make_mesh(model_parallel=N)`` lays every rank of the default process
group out as (world/N, N) over ('data', 'model') with
``torch.distributed.device_mesh.init_device_mesh``; its two sub-groups
carry the collectives.  'data' is data parallelism; 'model' is megatron
tensor parallelism for the transformer stacks, expert parallelism for the
MoE experts, or the pipeline axis (``parallel/pipeline_parallel``).

A placement cuts every rank's slice out of the full weights, in place:
parameters stay plain local tensors and each carved one is marked with
``_pm_axes = ('model',)``.  The spec functions give, per parameter or
buffer name, the torch dim cut over 'model' and an interleave factor:

  * column-parallel ``to_q`` / ``to_k`` / ``to_v`` (whole heads: rank r
    holds heads [r·H/tp, (r+1)·H/tp), the port's head-major ``_split``) and
    ``w12`` (output features, dim 0 of the torch (out, in) weight);
  * ``w12`` is the fused ``[w1 | w2]`` projection that ``SwiGLU`` splits in
    half, so it is carved half by half (interleave 2): rank r holds
    ``[w1_r | w2_r]``;
  * row-parallel ``to_out`` / ``w3`` (input features, dim 1); their biases
    stay whole and are added once, after the reduce;
  * the vocab head ``to_logits`` column-parallel over the vocab;
  * the MoE experts (E, out, in) over E (expert parallelism), the router
    replicated;
  * an int8 ``QLinear`` carves ``kernel_q`` like its fp weight; its
    per-channel ``scale`` goes with the output features (column-parallel)
    or stays whole (row-parallel), as ``_align_quantized`` places it.
    A row-parallel scale is taken over all of its input features, so a
    carved layer quantized later (``quantize_carved``) takes its abs-max
    over 'model' (an all-reduce MAX): either order gives the same tree.

``full_state_dict`` is the inverse (every rank gets the full tensors, in
the unplaced names), ``local_state_dict`` carves a full state dict for a
placed module; save and resume go through them, so a state written under
one mesh loads under any other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import collectives as C

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


class Mesh:
    """A (data, model) layout of the default process group's ranks: rank
    g sits at (g // model, g % model).  ``device`` is this rank's device."""

    def __init__(self, device_mesh, device):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        names = device_mesh.mesh_dim_names
        self.shape = {n: int(device_mesh.size(i)) for i, n in enumerate(names)}
        self._groups = {n: device_mesh.get_group(n) for n in names}

    def group(self, axis):
        return self._groups[axis]

    def size(self, axis):
        return self.shape.get(axis, 1)

    def rank(self, axis):
        return self.device_mesh.get_local_rank(axis)

    def group_of(self, axes):
        """The group spanning ``axes`` (None for no axis)."""
        axes = tuple(a for a in (DATA_AXIS, MODEL_AXIS) if a in axes)
        if not axes:
            return None
        if len(axes) == 2:
            return dist.group.WORLD
        return self._groups[axes[0]]

    def __repr__(self):
        return (f'Mesh(data={self.size(DATA_AXIS)}, model='
                f'{self.size(MODEL_AXIS)}, device={self.device})')


def check_mesh(mesh, what):
    """``mesh`` must be a ``Mesh`` (``make_mesh``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f'{what}: mesh must be a parallel.mesh.Mesh '
                        f'(make_mesh), got {type(mesh).__name__}')
    return mesh


def make_mesh(model_parallel=1, device=None,
              axis_names=(DATA_AXIS, MODEL_AXIS)):
    """(data, model) mesh over every rank; ``model_parallel=1`` is pure DP.
    Needs the default process group (``multihost.initialize``).  ``device``
    defaults to ``cuda:{LOCAL_RANK}`` under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'parallel.multihost.initialize() first')
    from torch.distributed.device_mesh import init_device_mesh
    from .multihost import device as default_device
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f'{n} ranks do not divide into model_parallel='
                         f'{model_parallel}')
    device = torch.device(device) if device is not None else default_device()
    dm = init_device_mesh(device.type, (n // model_parallel, model_parallel),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(dm, device)


def launch_mesh(device='cuda'):
    """Under ``torchrun``: the process group (``multihost.initialize``) and
    a pure data-parallel mesh over every rank; otherwise None."""
    from . import multihost
    if not multihost.launched():
        return None
    multihost.initialize(device='cpu' if str(device) == 'cpu' else 'cuda')
    return make_mesh()


def shard_batch(batch, mesh, grad_accum=1):
    """This data rank's rows of a global batch of ``grad_accum``
    microbatches (tensors, arrays, caption lists, or a tuple / list / dict
    of them): of each microbatch, data rank r of dp takes its r-th slice,
    so that the rank's microbatches are its slices of the global ones.
    Tensors and arrays come back as tensors on the mesh's device."""
    dp, r = mesh.size(DATA_AXIS), mesh.rank(DATA_AXIS)

    def rows(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, tuple) or (isinstance(x, list) and x and not
                                    isinstance(x[0], str)):
            return type(x)(rows(v) for v in x)
        n = len(x)
        if n % (dp * grad_accum):
            raise ValueError(f'batch {n} does not divide over dp={dp} × '
                             f'grad_accum={grad_accum}')
        m = n // (dp * grad_accum)
        picks = [i * dp * m + r * m + j for i in range(grad_accum)
                 for j in range(m)]
        if isinstance(x, list):
            return [x[i] for i in picks]
        t = torch.as_tensor(x if isinstance(x, torch.Tensor)
                            else np.asarray(x), device=mesh.device)
        return t.reshape(grad_accum, dp, m, *t.shape[1:])[:, r].reshape(
            grad_accum * m, *t.shape[1:])

    return rows(batch)


# ---------------------------------------------------------------------------
# Tensor-parallel placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class TPGroup:
    """What a tensor-parallel module needs: the 'model' group, its size and
    this rank's place; ``sequence`` shards the hidden state along the
    sequence between the sublayers (megatron sequence parallelism)."""
    group: object
    size: int
    rank: int
    sequence: bool = False


def _linear_spec(prefix, mod, kind, interleave=1):
    from ..nn.quant import QLinear
    col = kind == 'col'
    dim = 0 if col else 1
    out = {}
    if isinstance(mod, QLinear):
        out[prefix + 'kernel_q'] = (dim, interleave)
        if col:
            out[prefix + 'scale'] = (0, interleave)
    else:
        out[prefix + 'weight'] = (dim, interleave)
    if col and getattr(mod, 'bias', None) is not None:
        out[prefix + 'bias'] = (0, interleave)
    return out


def _blocks_spec(module, prefix=''):
    """Specs of every attention, SwiGLU and expert pool below ``module``."""
    from ..nn.attention import Attention
    from ..nn.mlp import SwiGLU
    from ..nn.moe import MoESwiGLU
    spec = {}
    for name, mod in module.named_modules():
        p = prefix + (name + '.' if name else '')
        if isinstance(mod, Attention):
            for lin in ('to_q', 'to_k', 'to_v'):
                spec.update(_linear_spec(f'{p}{lin}.', getattr(mod, lin), 'col'))
            spec.update(_linear_spec(f'{p}to_out.', mod.to_out, 'row'))
        elif isinstance(mod, SwiGLU):
            spec.update(_linear_spec(f'{p}w12.', mod.w12, 'col', 2))
            spec.update(_linear_spec(f'{p}w3.', mod.w3, 'row'))
        elif isinstance(mod, MoESwiGLU):
            for lin in ('w12', 'w3'):
                spec[f'{p}experts.{lin}.weight'] = (0, 1)
                spec[f'{p}experts.{lin}.bias'] = (0, 1)
    return spec


def vqgan_param_spec(vqgan, prefix=''):
    """The VQGAN's encoder and decoder stacks (``mesh.py:143-148``)."""
    spec = _blocks_spec(vqgan.encoder.layers, prefix + 'encoder.layers.')
    spec.update(_blocks_spec(vqgan.decoder.layers, prefix + 'decoder.layers.'))
    return spec


def cond_transformer_param_spec(transformer, prefix=''):
    """The stage-2 stack and the vocab head (``mesh.py:150-156``)."""
    spec = _blocks_spec(transformer.layers, prefix + 'layers.')
    spec.update(_linear_spec(prefix + 'to_logits.', transformer.to_logits, 'col'))
    return spec


def moe_cond_transformer_param_spec(transformer, prefix=''):
    """Attention megatron-parallel, each block's experts over 'model' (the
    router replicated), the vocab head column-parallel (``mesh.py:158``)."""
    return cond_transformer_param_spec(transformer, prefix)


def pipeline_param_spec(pipe):
    """The Pipeline's tree: VQGAN stacks, and the transformer's spec, the
    expert-parallel one for an MoE transformer."""
    tr = (moe_cond_transformer_param_spec if pipe.config.num_experts
          else cond_transformer_param_spec)
    return {**vqgan_param_spec(pipe.vqgan, 'vqgan.'),
            **tr(pipe.transformer, 'transformer.')}


def _default_spec(module):
    from ..models.pipeline import Pipeline
    from ..models.transformer import CondTransformer
    from ..models.vqmodel import VQModel
    if isinstance(module, Pipeline):
        return pipeline_param_spec(module)
    if isinstance(module, VQModel):
        return vqgan_param_spec(module)
    if isinstance(module, CondTransformer):
        return cond_transformer_param_spec(module)
    raise TypeError(f'no placement rules for {type(module).__name__}')


def _carve(t, dim, interleave, size, rank):
    parts = t.chunk(interleave, dim)
    step = parts[0].shape[dim] // size
    return torch.cat([p.narrow(dim, rank * step, step) for p in parts], dim)


def _uncarve(t, dim, interleave, group):
    """All-gather a carved tensor back to the full one."""
    g = C.all_gather(t, group, dim)
    if interleave == 1:
        return g
    ranks = g.chunk(dist.get_world_size(group), dim)
    halves = [r.chunk(interleave, dim) for r in ranks]
    return torch.cat([h[i] for i in range(interleave) for h in halves], dim)


def _tp_modules(module, spec):
    """(module, name) of the modules a spec places, with the checks."""
    from ..models.transformer import CondTransformer
    from ..nn.attention import Attention
    from ..nn.mlp import SwiGLU
    from ..nn.moe import MoESwiGLU
    for name, mod in module.named_modules():
        p = name + '.' if name else ''
        if isinstance(mod, Attention) and (p + 'to_out.weight' in spec or
                                           p + 'to_out.kernel_q' in spec):
            yield name, mod
        elif isinstance(mod, SwiGLU) and (p + 'w3.weight' in spec or
                                          p + 'w3.kernel_q' in spec):
            yield name, mod
        elif isinstance(mod, MoESwiGLU) and p + 'experts.w3.weight' in spec:
            yield name, mod
        elif isinstance(mod, CondTransformer) and (
                p + 'to_logits.weight' in spec
                or p + 'to_logits.kernel_q' in spec):
            yield name, mod


def _check_divides(module, spec, tp):
    from ..nn.attention import Attention
    from ..nn.moe import MoESwiGLU
    for name, mod in _tp_modules(module, spec):
        if isinstance(mod, Attention) and mod.heads % tp:
            raise ValueError(f'{name}: {mod.heads} heads do not divide over '
                             f"model={tp} (tensor parallelism shards whole "
                             'heads)')
        if isinstance(mod, MoESwiGLU) and mod.num_experts % tp:
            raise ValueError(f'{name}: {mod.num_experts} experts do not '
                             f'divide over model={tp}')
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    for key, (dim, inter) in spec.items():
        n = tensors[key].shape[dim] // inter
        if n % tp:
            raise ValueError(f'{key}: {n} features do not divide over '
                             f'model={tp}')


@torch.no_grad()
def shard_params(module, mesh, spec=None, *, sequence_parallel=False):
    """Carve ``module``'s weights for ``mesh``'s 'model' axis, in place, and
    switch its attention, SwiGLU, expert and head modules to their
    tensor-parallel forms.  ``spec`` defaults to the module's rules
    (Pipeline, VQModel, CondTransformer); ``spec={}`` is pure data
    parallelism (everything replicated).  ``sequence_parallel`` shards the
    stage-2 transformer's hidden state along the sequence.  Returns the
    module."""
    if placed(module):
        raise RuntimeError(f'{type(module).__name__} is already placed')
    spec = _default_spec(module) if spec is None else dict(spec)
    tp, r = mesh.size(MODEL_AXIS), mesh.rank(MODEL_AXIS)
    _check_divides(module, spec, tp)
    group = mesh.group(MODEL_AXIS)
    info = TPGroup(group, tp, r)
    seq = TPGroup(group, tp, r, sequence=True)
    owners = {}
    for name, mod in module.named_modules():
        for leaf, t in list(mod._parameters.items()) + list(mod._buffers.items()):
            if t is not None:
                owners[(name + '.' if name else '') + leaf] = (mod, leaf)
    for key, (dim, inter) in spec.items():
        mod, leaf = owners[key]
        old = getattr(mod, leaf)
        new = _carve(old.data, dim, inter, tp, r).clone()
        if isinstance(old, nn.Parameter):
            new = nn.Parameter(new, requires_grad=old.requires_grad)
            mod._parameters[leaf] = new
        else:
            mod._buffers[leaf] = new
        new._pm_axes = (MODEL_AXIS,)
        mod.__dict__.setdefault('_pm_carve', {})[leaf] = (dim, inter)
        mod._pm_mesh = mesh
    for name, mod in _tp_modules(module, spec):
        in_transformer = name.startswith('transformer') or (
            not name.startswith('vqgan') and _is_transformer(module))
        mod.tp = seq if sequence_parallel and in_transformer else info
        _localize(mod, tp)
    module._pm_mesh = mesh
    return module


def _is_transformer(module):
    from ..models.transformer import CondTransformer
    return isinstance(module, CondTransformer)


def _localize(mod, tp):
    """Local head / feature counts after a carve."""
    from ..nn.attention import Attention
    from ..nn.quant import QLinear
    for m in mod.modules():
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
        elif isinstance(m, QLinear):
            m.out_features, m.in_features = m.kernel_q.shape
    if isinstance(mod, Attention):
        mod.heads //= tp


def whole_features(linear):
    """(in, out) features of the layer a (carved) ``Linear`` is cut from."""
    out, inp = linear.weight.shape
    carve = linear.__dict__.get('_pm_carve', {}).get('weight')
    if carve is None:
        return inp, out
    tp = linear._pm_mesh.size(MODEL_AXIS)
    return (inp * tp, out) if carve[0] == 1 else (inp, out * tp)


@torch.no_grad()
def quantize_carved(linear, mode):
    """The ``QLinear`` of a carved ``Linear``: its slice of the whole
    layer's, placed as ``shard_params`` carves a ``QLinear``.  A
    column-parallel slice holds every input feature of its rows, so its
    scales are its own; a row-parallel one holds a part of each row, so its
    abs-max is all-reduced (MAX) over 'model' first.  Every rank of 'model'
    calls it."""
    from ..nn.quant import QLinear, quantize_weight
    dim, inter = linear.__dict__['_pm_carve']['weight']
    mesh = linear._pm_mesh
    reduce = None
    if dim == 1:
        def reduce(amax):
            return C.all_reduce(amax, mesh.group(MODEL_AXIS),
                                dist.ReduceOp.MAX)
    wq, scale = quantize_weight(linear.weight.detach(), reduce)
    q = QLinear(wq, scale, linear.bias, mode=mode)
    q._pm_carve = _linear_spec('', q, 'col' if dim == 0 else 'row', inter)
    for leaf in q._pm_carve:
        getattr(q, leaf)._pm_axes = (MODEL_AXIS,)
    q._pm_mesh = mesh
    return q


def placed(module):
    """True when ``module`` (or a submodule) holds a carve or a stage."""
    return any(m.__dict__.get('_pm_carve') or getattr(m, '_pp', None)
               is not None for m in module.modules())


def _carves(module):
    """{state-dict name: (dim, interleave, mesh)} of the carved tensors."""
    out = {}
    for name, mod in module.named_modules():
        for leaf, (dim, inter) in mod.__dict__.get('_pm_carve', {}).items():
            out[(name + '.' if name else '') + leaf] = (dim, inter,
                                                        mod._pm_mesh)
    return out


def full_state_dict(module, device='cpu'):
    """``module.state_dict()`` with every carved tensor gathered whole and
    every pipeline stage's layers merged, in the unplaced names, on every
    rank (on ``device``).  The identity for an unplaced module."""
    sd = dict(module.state_dict())
    for key, (dim, inter, mesh) in _carves(module).items():
        sd[key] = _uncarve(sd[key], dim, inter, mesh.group(MODEL_AXIS))
    sd = {k: v.detach().to(device, copy=True) for k, v in sd.items()}
    from .pipeline_parallel import merge_stages
    return merge_stages(module, sd)


def local_state_dict(module, full):
    """The inverse of ``full_state_dict``: the entries of a full state dict
    this rank's placed ``module`` holds, carved to its slices."""
    carves = _carves(module)
    out = {}
    for key in module.state_dict():
        if key not in full:
            raise KeyError(f'the state has no {key!r}')
        v = full[key]
        if key in carves:
            dim, inter, mesh = carves[key]
            v = _carve(v, dim, inter, mesh.size(MODEL_AXIS),
                       mesh.rank(MODEL_AXIS))
        out[key] = v
    return out


def _carve_of(module, name):
    prefix, _, leaf = name.rpartition('.')
    mod = dict(module.named_modules()).get(prefix)
    spec = None if mod is None else mod.__dict__.get('_pm_carve', {}).get(leaf)
    return (spec, mod)


def carve_like(module, name, full):
    """``full`` (a tensor shaped like the unplaced parameter ``name``)
    carved as that parameter is: the optimizer moments follow their
    parameter."""
    spec, mod = _carve_of(module, name)
    if spec is None:
        return full
    mesh = mod._pm_mesh
    return _carve(full, *spec, mesh.size(MODEL_AXIS), mesh.rank(MODEL_AXIS))


def uncarve_like(module, name, local):
    """The inverse of ``carve_like`` (a collective over 'model')."""
    spec, mod = _carve_of(module, name)
    if spec is None:
        return local
    return _uncarve(local, *spec, mod._pm_mesh.group(MODEL_AXIS))


def zero_opt_spec(shapes, mesh, min_size=16384):
    """ZeRO-1: for each (name -> shape), the dim its optimizer state is
    sliced on over 'data' (the first one divisible by dp, for a tensor of
    at least ``min_size`` elements), or None (replicated: small tensors,
    step counters, norms)."""
    dp = mesh.size(DATA_AXIS)
    out = {}
    for name, shape in shapes.items():
        out[name] = None
        if int(np.prod(shape)) >= min_size:
            for axis, dim in enumerate(shape):
                if dim % dp == 0 and dim >= dp:
                    out[name] = axis
                    break
    return out
