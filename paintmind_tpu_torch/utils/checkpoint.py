"""Checkpoint IO for the JAX package's ``.npz`` parameter trees.

The JAX package saves a flat archive of ``/``-joined keys
(``paintmind_tpu/utils/checkpoint.py``).  numpy has no bfloat16, so a bf16
leaf is stored as its raw uint16 payload under the key plus ``::bf16``;
artifacts written before that tag hold the raw two bytes as an opaque
``V2`` dtype.  Both come back here as ``torch.bfloat16`` tensors, and
``save_params`` writes the tagged form, so an archive written here loads in
the JAX package.  Orbax directories and reference ``.pt`` files are not read
by the port yet (ROADMAP).
"""

from __future__ import annotations

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


def load_flat(path):
    """npz -> flat {key: CPU tensor} with bf16 tags resolved."""
    path = str(path)
    if not path.endswith('.npz'):
        raise NotImplementedError(
            f'{path!r}: the port reads .npz parameter archives only; orbax '
            'directories and .pt files wait for a later slice (ROADMAP)')
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
