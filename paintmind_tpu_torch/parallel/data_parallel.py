"""Data-parallel gradients, ZeRO-1 and global-norm clipping over a mesh.

After a step's microbatches, ``GradSync.reduce`` averages the gradients
over 'data' (flat buckets, one all-reduce each; the parameters used before
a pipeline are first summed over the stages, ``pipeline_parallel``), and
the optimizer steps.  With ``zero=True`` (ZeRO-1, the JAX package's
``zero_opt_spec``): each trainable tensor of at least ``min_size``
elements whose some dim divides by dp has its optimizer state on a slice
of that dim: its gradient is reduce-scattered there, the optimizer updates
the slice (``opt_params``), and ``gather`` all-gathers the slices back
into the parameter.  Lion, Adam and AdamW are elementwise, so a slice's
update equals the replicated update of those elements.

``clip_by_global_norm`` counts each tensor once over the mesh: the squares
of a carved or sliced tensor's parts are summed over the axes it is split
on, a replicated one's taken once.  At world size 1 it is
``torch.nn.utils.clip_grad_norm_`` itself (every collective would be the
identity), so a one-rank mesh updates the unplaced bits.
"""

from __future__ import annotations

import functools

import torch

from . import collectives as C
from .mesh import DATA_AXIS, MODEL_AXIS, carve_like, uncarve_like, \
    zero_opt_spec

BUCKET = 1 << 25  # elements per all-reduce bucket


def axes_of(t):
    return getattr(t, '_pm_axes', ())


def clip_by_global_norm(tensors, max_norm, mesh):
    """Scale the gradients of ``tensors`` so that their global norm over
    the mesh is at most ``max_norm``; returns that norm."""
    if mesh.size(DATA_AXIS) * mesh.size(MODEL_AXIS) == 1:
        return torch.nn.utils.clip_grad_norm_(tensors, max_norm)
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return torch.zeros(())
    by_axes = {}
    for t in tensors:
        if t.grad is not None:
            by_axes.setdefault(axes_of(t), []).append(t.grad)
    total = torch.zeros((), dtype=torch.float64, device=grads[0].device)
    for axes, gs in sorted(by_axes.items()):
        sq = torch.stack([torch.linalg.vector_norm(g.float()).double() ** 2
                          for g in gs]).sum()
        group = mesh.group_of(axes)
        if group is not None:
            C.all_reduce(sq, group)
        total = total + sq
    norm = total.sqrt().float()
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, coef.to(grads[0].device))
    return norm


def gather_named(module, named, name_of=lambda key: key):
    """{key: this rank's tensor shaped like the parameter ``name_of(key)``
    of ``module``} -> {key: the whole tensor (CPU)}: carves gathered over
    'model', the other pipeline stages' entries merged in."""
    out = {k: uncarve_like(module, name_of(k), v).cpu()
           for k, v in named.items()}
    staged = [m for m in module.modules()
              if getattr(m, '_pp', None) is not None]
    if staged:
        for part in C.all_gather_object(out, staged[0]._pp.group):
            out.update(part)
    return out


class GradSync:
    """The gradient traffic of one set of trainable tensors on ``mesh``.
    ``pipe_sum``: tensors whose gradients the pipeline stages hold in parts
    (summed over 'model' first).  ``opt_params`` are what the optimizer must
    be built over (ZeRO slices in place of the sliced parameters)."""

    def __init__(self, params, mesh, *, zero=False, min_size=16384,
                 pipe_sum=()):
        self.params = list(params)
        self.mesh = mesh
        self.dp = mesh.size(DATA_AXIS)
        self.group = mesh.group(DATA_AXIS)
        pipe = {id(p) for p in pipe_sum}
        self.pipe_sum = [p for p in self.params if id(p) in pipe]
        dims = (zero_opt_spec({i: tuple(p.shape)
                               for i, p in enumerate(self.params)},
                              mesh, min_size) if zero else {})
        self.slices = {}
        self.opt_params = []
        for i, p in enumerate(self.params):
            d = dims.get(i)
            if d is None:
                self.opt_params.append(p)
                continue
            part = C.local_slice(p.detach(), self.group, d).clone()
            part._pm_axes = tuple(axes_of(p)) + (DATA_AXIS,)
            self.slices[i] = (d, part)
            self.opt_params.append(part)

    @property
    def sliced(self):
        return len(self.slices)

    def install(self, optimizer):
        """Make ``optimizer`` (built over ``opt_params``) clip by the norm
        over the mesh."""
        optimizer.clip_fn = functools.partial(clip_by_global_norm,
                                              mesh=self.mesh)
        return optimizer

    @torch.no_grad()
    def reduce(self):
        """Mean gradients over 'data' into the optimizer's tensors."""
        if self.pipe_sum:
            self._bucketed([p.grad for p in self.pipe_sum],
                           self.mesh.group(MODEL_AXIS), 1.0)
        plain = [p.grad for i, p in enumerate(self.params)
                 if i not in self.slices]
        self._bucketed(plain, self.group, 1.0 / self.dp)
        for i, (d, part) in self.slices.items():
            g = C.reduce_scatter(self.params[i].grad, self.group, d)
            part.grad = g.mul_(1.0 / self.dp)

    def _bucketed(self, grads, group, scale):
        grads = [g for g in grads if g is not None]
        start = 0
        while start < len(grads):
            stop, n = start, 0
            while stop < len(grads) and (n == 0 or n + grads[stop].numel()
                                         <= BUCKET):
                n += grads[stop].numel()
                stop += 1
            chunk = grads[start:stop]
            flat = torch.cat([g.reshape(-1) for g in chunk])
            C.all_reduce(flat, group)
            flat.mul_(scale)
            at = 0
            for g in chunk:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
            start = stop

    @torch.no_grad()
    def refresh(self):
        """The slices again from the parameters (after a resume)."""
        for i, (d, part) in self.slices.items():
            part.copy_(C.local_slice(self.params[i].detach(), self.group, d))

    @torch.no_grad()
    def gather(self):
        """The updated slices back into the whole parameters."""
        for i, (d, part) in self.slices.items():
            self.params[i].copy_(C.all_gather(part, self.group, d))

    # -- the optimizer state in the unplaced layout -----------------------

    def full_state(self, optimizer, module, names, full_names):
        """``optimizer.state_dict()`` as the unplaced trainer writes it:
        every moment whole, indexed in ``full_names`` order.  ``names`` are
        the names (in ``module``) of this rank's ``params``."""
        local = optimizer.state_dict()
        moments = {}
        for i, name in enumerate(names):
            for k, v in local['state'].get(i, {}).items():
                if torch.is_tensor(v) and v.ndim > 0:
                    if i in self.slices:
                        v = C.all_gather(v, self.group, self.slices[i][0])
                    moments[f'{k}\0{name}'] = v
        mine = {}
        for i, name in enumerate(names):
            if i in local['state']:
                mine[name] = {k: v for k, v in local['state'][i].items()
                              if not (torch.is_tensor(v) and v.ndim > 0)}
        staged = [m for m in module.modules()
                  if getattr(m, '_pp', None) is not None]
        if staged:
            for part in C.all_gather_object(mine, staged[0]._pp.group):
                mine.update(part)
        for key, v in gather_named(module, moments,
                                   lambda k: k.split('\0')[1]).items():
            k, name = key.split('\0')
            mine[name][k] = v
        index = {n: j for j, n in enumerate(full_names)}
        groups = [{**g, 'params': list(range(len(full_names)))}
                  for g in local['param_groups']]
        out = {**{k: v for k, v in local.items()
                  if k not in ('state', 'param_groups')},
               'state': {index[n]: st for n, st in mine.items()},
               'param_groups': groups}
        return out

    def load_full_state(self, optimizer, state, module, names, full_names):
        """The inverse: an unplaced optimizer state dict into this rank's
        optimizer (carved and sliced)."""
        index = {n: j for j, n in enumerate(full_names)}
        local = {}
        for i, name in enumerate(names):
            st = state['state'].get(index[name])
            if st is None:
                continue
            out = {}
            for k, v in st.items():
                if torch.is_tensor(v) and v.ndim > 0:
                    v = carve_like(module, name, v)
                    if i in self.slices:
                        v = C.local_slice(v, self.group, self.slices[i][0])
                    v = v.clone()
                out[k] = v
            local[i] = out
        groups = [{**g, 'params': list(range(len(names)))}
                  for g in state['param_groups']]
        optimizer.load_state_dict({
            **{k: v for k, v in state.items()
               if k not in ('state', 'param_groups')},
            'state': local, 'param_groups': groups})
