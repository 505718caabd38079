"""Checkpoint IO for the JAX package's ``.npz`` parameter trees.

The JAX package saves a flat archive of ``/``-joined keys
(``paintmind_tpu/utils/checkpoint.py``).  numpy has no bfloat16, so a bf16
leaf is stored as its raw uint16 payload under the key plus ``::bf16``;
artifacts written before that tag hold the raw two bytes as an opaque
``V2`` dtype.  Both come back here as ``torch.bfloat16`` tensors, and
``save_params`` writes the tagged form, so an archive written here loads in
the JAX package.

Reference checkpoints (``.pt``, ``.pth``, ``.bin`` state dicts, as the
reference publishes its weights) are converted on load to the same flat
tree (``convert/torch_weights``).  A trainer's state file
(``<prefix>_state_<N>.pt``) is not a model checkpoint and is refused; it is
read by the trainer's ``resume()``.  Orbax directories are not read by the
port (a multi-GPU run's state file is one ``torch.save`` of whole tensors,
which any mesh resumes from).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

SEP = '/'
BF16_TAG = '::bf16'


def to_tensor(key, value):
    """(key, array) -> (key without tag, CPU tensor), resolving the bf16
    encodings above and an ``ml_dtypes`` bfloat16 array as JAX returns it."""
    if isinstance(value, torch.Tensor):
        return key, value
    arr = np.asarray(value)
    raw_bf16 = (key.endswith(BF16_TAG)
                or (arr.dtype.kind == 'V' and arr.dtype.itemsize == 2)
                or arr.dtype.name == 'bfloat16')
    if key.endswith(BF16_TAG):
        key = key[:-len(BF16_TAG)]
    if raw_bf16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return key, torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return key, torch.from_numpy(np.array(arr, copy=True))


_TORCH_SUFFIXES = ('.pt', '.pth', '.bin')
_TRAIN_STATE = re.compile(r'_state_\d+\.pt$')


def _refuse_train_state(path):
    raise ValueError(
        f'{path!r} is a trainer state file (model, optimizer, step and '
        'generators), not a model checkpoint: continue the run with '
        "VQGANTrainer/PaintMindTrainer.resume(path), or load the model from "
        'the .npz export saved beside it')


def load_reference(path, model):
    """A reference state dict (``torch.load``, weights only) -> flat
    {key: CPU tensor}, converted as ``model`` ('vqgan', 'pipeline' or
    'cond_transformer').  A trainer's state file is refused, by its name
    (``*_state_<N>.pt``) before it is read, or by its content."""
    from ..convert import from_jax, torch_weights
    path = str(path)
    if _TRAIN_STATE.search(os.path.basename(path)):
        _refuse_train_state(path)
    if model not in torch_weights.CONVERTERS:
        raise ValueError(f'{path!r}: a reference state dict is converted '
                         f"as model 'vqgan', 'pipeline' or "
                         f"'cond_transformer', got {model!r}")
    sd = torch_weights.load_torch_state_dict(path)
    if 'step' in sd and 'model' in sd:
        _refuse_train_state(path)
    return from_jax.flatten_tree(torch_weights.CONVERTERS[model](sd))


def load_flat(path, model=None):
    """A checkpoint -> flat {key: CPU tensor}: an ``.npz`` archive with bf16
    tags resolved, or a reference state dict (``.pt`` / ``.pth`` / ``.bin``)
    converted as ``model`` (``load_reference``)."""
    path = str(path)
    if path.endswith(_TORCH_SUFFIXES):
        return load_reference(path, model)
    if not path.endswith('.npz'):
        raise NotImplementedError(
            f'{path!r}: the port reads .npz archives and reference .pt / '
            '.pth / .bin state dicts; it does not read orbax directories '
            '(its multi-GPU state files are one torch.save of whole '
            'tensors)')
    with np.load(path) as data:
        return dict(to_tensor(k, data[k]) for k in data.files)


def to_numpy(key, value):
    """(key, CPU tensor) -> (key, array) as the archive stores it: a bf16
    tensor becomes its uint16 payload under the key plus ``::bf16``."""
    value = value.contiguous()
    if value.dtype == torch.bfloat16:
        return key + BF16_TAG, value.view(torch.int16).numpy().view(np.uint16)
    return key, value.numpy()


def save_params(path, flat):
    """Write a flat ``{key: array}`` tree (``convert.from_jax.to_flat``) as
    the JAX package's ``.npz`` archive."""
    path = str(path)
    if not path.endswith('.npz'):
        raise NotImplementedError(
            f'{path!r}: the port writes .npz parameter archives only')
    np.savez(path, **flat)
    return path


def save_placed(module, path):
    """``save_params(path, to_flat(module))`` for a module that may be
    placed on a mesh: every rank gathers the whole tensors (a collective),
    rank 0 writes, all wait.  Returns ``path``."""
    from ..convert.from_jax import to_flat
    from ..parallel.mesh import full_state_dict, placed
    from ..parallel.multihost import barrier, is_main_process
    sharded = placed(module)
    flat = to_flat(module, full_state_dict(module) if sharded else None)
    if is_main_process():
        save_params(path, flat)
    if sharded:
        barrier()
    return path
