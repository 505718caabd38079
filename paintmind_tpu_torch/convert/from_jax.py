"""Weight bridge between the JAX package's flat parameter tree and the
port's modules, both ways (``load_jax_params`` in, ``to_flat`` out).

Input is a flat ``{'/'-joined key: array}`` dict: the ``.npz`` layout, and
what ``paintmind_tpu.utils.checkpoint.flatten_tree`` returns for a live JAX
tree (the tests pass that in).  Three layout differences are bridged:

  * transformer stacks: every leaf under a ``layers`` node carries a leading
    ``depth`` axis (one ``lax.scan`` over stacked weights); the port keeps an
    ``nn.ModuleList``, so leaf ``i`` of that axis goes to ``layers.{i}``;
  * linear kernels: JAX stores ``kernel`` as (in, out), torch's ``weight``
    is (out, in); the MoE experts' stacked kernels (E, in, out) are
    ``StackedLinear`` weights (E, out, in);
  * LayerNorm: JAX ``scale`` / ``bias`` are torch ``weight`` / ``bias``;
  * int8 linears (``nn.quant.QLinear``): ``kernel_q`` int8 (in, out) is the
    module's (out, in) ``kernel_q``; ``scale`` (fp32, per output channel),
    ``dyn`` (the ``w8a8`` marker, zero-size) and ``bias`` keep their names.

Every other leaf (``pos_embed``, ``codebook``, ``mask_token``) keeps its
name and shape.  Loading is strict: a key the module lacks, or a parameter
the tree lacks, raises.

The conditioning towers' trees (``paintmind_tpu/models/t5.py``, ``clip.py``)
have a layout of their own, bridged by ``load_tower_params`` /
``tower_to_flat``:

  * T5: linear kernels are bare (in, out) leaves (``blocks/q``), norms and
    embeddings bare vectors and tables (``blocks/ln0``, ``embed``,
    ``rel_bias``), and every leaf under ``blocks`` is depth-stacked;
  * CLIP: ``resblocks`` is a list (``resblocks/<i>/...``, not stacked); a
    linear layer with a bias is two leaves ``<name>_w`` (in, out) and
    ``<name>_b``, one without (``conv1``) a bare kernel; LayerNorms are
    ``<name>/scale`` and ``<name>/bias``.

The stage-1 training trees, a list per layer, are carried in by
``load_discriminator_params`` (the PatchGAN's ``params`` and BatchNorm
``stats``: ``<i>/conv/kernel`` HWIO, ``<i>/conv/bias``, ``<i>/bn/scale``,
``<i>/bn/bias``, ``<i>/bn/mean``, ``<i>/bn/var``) and
``load_lpips_params`` (``convs/<i>/kernel`` HWIO and ``/bias``,
``lins/<i>/kernel`` (1, 1, C, 1)), and the InceptionV3 tree by
``load_inception_params``.  Torch convolutions are OIHW.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ..nn.moe import StackedLinear
from ..nn.quant import QLinear
from ..utils.checkpoint import SEP, to_numpy, to_tensor

TOWER_STACK = 'blocks'  # the tower node whose leaves are depth-stacked (T5)


def to_state_dict(flat):
    """Flat JAX tree -> torch state_dict (CPU tensors)."""
    flat = dict(to_tensor(k, v) for k, v in flat.items())
    # a quantized linear's node: its 'scale' is no LayerNorm weight
    quantized = {k.rsplit(SEP, 1)[0] for k in flat
                 if k.endswith(SEP + 'kernel_q')}
    sd = {}
    for key, value in flat.items():
        parts = key.split(SEP)
        leaf = parts[-1]
        if leaf in ('kernel', 'kernel_q'):
            parts[-1] = 'weight' if leaf == 'kernel' else leaf
            value = value.transpose(-1, -2)
        elif leaf == 'scale' and SEP.join(parts[:-1]) not in quantized:
            parts[-1] = 'weight'
        if 'layers' in parts[:-1]:
            at = parts.index('layers') + 1
            for i in range(value.shape[0]):
                sd['.'.join(parts[:at] + [str(i)] + parts[at:])] = \
                    value[i].contiguous()
        else:
            sd['.'.join(parts)] = value.contiguous()
    return sd


@torch.no_grad()
def load_jax_params(module, flat):
    """Copy a flat JAX parameter tree into ``module`` (in place, keeping
    the module's device and dtypes).  Every key of the tree must be
    consumed and every parameter of the module filled."""
    return _load_strict(module, to_state_dict(flat))


@torch.no_grad()
def _load_strict(module, sd):
    """Copy a state dict into ``module``'s own tensors: every key consumed,
    every entry of the module filled, shapes equal."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f'parameter tree does not match {type(module).__name__}:'
                       f' missing {missing[:8]}, unexpected {unexpected[:8]}')
    for name, value in sd.items():
        if own[name].shape != value.shape:
            raise ValueError(f'shape mismatch for {name!r}: tree '
                             f'{tuple(value.shape)} vs module '
                             f'{tuple(own[name].shape)}')
        own[name].copy_(value)
    return module


@torch.no_grad()
def to_flat(module, state=None):
    """The reverse bridge: ``module``'s parameters as the flat
    ``{'/'-joined key: numpy array}`` tree of the JAX package, ready for
    ``utils.checkpoint.save_params``.  Linear and ``StackedLinear``
    ``weight`` becomes ``kernel`` (its last two axes swapped), LayerNorm
    ``weight`` becomes ``scale``, a ``QLinear``'s buffers are written beside
    its bias (``kernel_q`` transposed), and the leaves of ``layers.{i}``
    are restacked along a leading depth axis.
    A bf16 leaf is its raw uint16 payload under the key plus ``::bf16``.
    ``state``: a whole state dict of a placed ``module`` (``parallel.mesh.
    full_state_dict``) to write in place of the module's own tensors; a
    layer this rank's pipeline stage does not hold takes the type of one
    it does (a stack's layers are alike)."""
    mods = dict(module.named_modules())
    if state is None:
        items = []
        for prefix, mod in mods.items():
            tensors = list(mod.named_parameters(recurse=False))
            if isinstance(mod, QLinear):
                tensors += list(mod.named_buffers(recurse=False))
            items += [(prefix, mod, name, v) for name, v in tensors]
    else:
        items = []
        for key, value in state.items():
            prefix, _, name = key.rpartition('.')
            mod = _owner(mods, prefix)
            if name in mod._parameters or isinstance(mod, QLinear):
                items.append((prefix, mod, name, value))
    leaves, stacks = {}, {}
    for prefix, mod, name, value in items:
        value = value.detach().cpu()
        if isinstance(mod, (nn.Linear, StackedLinear)) and name == 'weight':
            name, value = 'kernel', value.transpose(-1, -2)
        elif name == 'kernel_q':
            value = value.transpose(-1, -2)
        elif isinstance(mod, nn.LayerNorm) and name == 'weight':
            name = 'scale'
        key = SEP.join(filter(None, [*prefix.split('.'), name]))
        m = re.fullmatch(r'(.*layers)/(\d+)/(.*)', key)
        if m:
            stacks.setdefault(f'{m[1]}/{m[3]}', {})[int(m[2])] = value
        else:
            leaves[key] = value
    for key, by_layer in stacks.items():
        leaves[key] = torch.stack([by_layer[i] for i in sorted(by_layer)])
    return dict(to_numpy(k, v) for k, v in leaves.items())


def _owner(mods, prefix):
    if prefix in mods:
        return mods[prefix]
    m = re.fullmatch(r'(.*layers)\.(\d+)(.*)', prefix)
    if m:
        for name, mod in mods.items():
            h = re.fullmatch(re.escape(m[1]) + r'\.\d+' + re.escape(m[3]),
                             name)
            if h:
                return mod
    raise KeyError(f'no module {prefix!r} to take the layout of')


def flatten_tree(tree, prefix=''):
    """A nested JAX tree (dicts and lists of arrays) or a flat dict ->
    ``{'/'-joined key: CPU tensor}``."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f'{prefix}{k}'
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_tree(v, key + SEP))
        else:
            key, out_v = to_tensor(key, v)
            out[key] = out_v
    return out


def _hwio_to_oihw(kernel):
    return kernel.permute(3, 2, 0, 1).contiguous()


def load_discriminator_params(module, params, stats=None):
    """The JAX package's discriminator ``params`` (and BatchNorm ``stats``,
    when given) into a ``models.discriminator.Discriminator``, in place.
    Without ``stats`` the module's running statistics are kept (the check
    then covers the parameters only)."""
    sd = {}
    for key, v in flatten_tree(params).items():
        i, mod, leaf = key.split(SEP)
        if mod == 'conv':
            sd[f'layers.{i}.conv.' + ('weight' if leaf == 'kernel' else 'bias')] = \
                _hwio_to_oihw(v) if leaf == 'kernel' else v
        else:
            sd[f'layers.{i}.bn.' + ('weight' if leaf == 'scale' else 'bias')] = v
    if stats is None:
        sd.update({k: v for k, v in module.state_dict().items()
                   if k.endswith(('running_mean', 'running_var'))})
    else:
        for key, v in flatten_tree(stats).items():
            i, _, leaf = key.split(SEP)
            sd[f'layers.{i}.bn.running_{leaf}'] = v
    return _load_strict(module, sd)


def load_lpips_params(module, tree):
    """The JAX package's LPIPS tree (nested or flat) into a
    ``models.lpips.LPIPS``, in place."""
    sd = {}
    for key, v in flatten_tree(tree).items():
        group, i, leaf = key.split(SEP)
        if group == 'lins':
            sd[f'lins.{i}'] = v[0, 0, :, 0].contiguous()
        else:
            sd[f'convs.{i}.' + leaf.replace('kernel', 'weight')] = \
                _hwio_to_oihw(v) if leaf == 'kernel' else v
    return _load_strict(module, sd)


def load_inception_params(module, tree):
    """The JAX package's InceptionV3 tree (nested, as
    ``models.inception.convert_inception`` returns it, or flat, as an
    ``.npz`` holds it: ``<name>[/<branch>]/{kernel, scale, bias, mean,
    var}``, kernels HWIO) into a ``models.inception.InceptionV3``, in
    place.  Strict, as ``load_jax_params``."""
    sd = {}
    for key, v in flatten_tree(tree).items():
        *path, leaf = key.split(SEP)
        if leaf == 'kernel':
            leaf, v = 'weight', _hwio_to_oihw(v)
        sd['.'.join([*path, leaf])] = v.float()
    return _load_strict(module, sd)


def _tower_leaves(module):
    """(parameter name, tree key, layer index or None, transposed?) for every
    parameter of a T5 or CLIP tower module."""
    for prefix, mod in module.named_modules():
        path = [p for p in prefix.split('.') if p]
        index = None
        if path[:1] == [TOWER_STACK] and len(path) > 1:
            index, path = int(path[1]), path[:1] + path[2:]
        for name, _ in mod.named_parameters(recurse=False):
            full = f'{prefix}.{name}' if prefix else name
            key, transpose = SEP.join(path), False
            if isinstance(mod, nn.LayerNorm):
                key += SEP + ('scale' if name == 'weight' else 'bias')
            elif isinstance(mod, nn.Linear):
                transpose = name == 'weight'
                if mod.bias is not None:
                    key += '_w' if name == 'weight' else '_b'
            elif not isinstance(mod, nn.Embedding) and name != 'weight':
                key = SEP.join(path + [name])  # a bare parameter of the module
            yield full, key, index, transpose


@torch.no_grad()
def load_tower_params(module, flat):
    """Copy a flat T5 or CLIP tree of the JAX package into a tower module
    (in place, keeping its device and dtypes).  Strict, as
    ``load_jax_params``."""
    flat = dict(to_tensor(k, v) for k, v in flat.items())
    params = dict(module.named_parameters())
    used = set()
    for name, key, index, transpose in _tower_leaves(module):
        if key not in flat:
            raise KeyError(f'parameter tree does not match '
                           f'{type(module).__name__}: missing {key!r}')
        used.add(key)
        value = flat[key] if index is None else flat[key][index]
        if transpose:
            value = value.t()
        if params[name].shape != value.shape:
            raise ValueError(f'shape mismatch for {key!r}: tree '
                             f'{tuple(value.shape)} vs module '
                             f'{tuple(params[name].shape)}')
        params[name].copy_(value)
    unexpected = sorted(set(flat) - used)
    if unexpected:
        raise KeyError(f'parameter tree does not match {type(module).__name__}:'
                       f' unexpected {unexpected[:8]}')
    return module


@torch.no_grad()
def tower_to_flat(module):
    """The reverse: a tower module's parameters as the JAX package's flat
    ``{key: numpy array}`` tree, ready for ``utils.checkpoint.save_params``."""
    params = dict(module.named_parameters())
    leaves, stacks = {}, {}
    for name, key, index, transpose in _tower_leaves(module):
        value = params[name].detach().cpu()
        if transpose:
            value = value.t()
        if index is None:
            leaves[key] = value
        else:
            stacks.setdefault(key, {})[index] = value
    for key, by_layer in stacks.items():
        leaves[key] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    return dict(to_numpy(k, v) for k, v in leaves.items())
