"""Resolution adaptation (the port's counterpart of
``paintmind_tpu/convert/resolution.py``): interpolate learned position
embeddings so a checkpoint trained at one image size initializes a
higher-resolution variant (e.g. the 256² ``vit-s-vqgan`` -> the 512²
extension, 1024 -> 4096 latent tokens; config.py).

Standard ViT practice (DeiT/MAE fine-tuning): reshape the (1, g², D) table
to its (g, g, D) grid, resize it to the new grid, flatten back.  The resize
is ``jax.image.resize(..., 'cubic')`` (Keys a = -0.5, antialiased when it
shrinks), through ``ops.image.resize_cubic``; ``F.interpolate``'s bicubic
(a = -0.75, other edges) would give other tables.  All other weights
transfer unchanged: the patch size is the same, only the token count grows.

Trees are the flat ``{'/'-joined key: tensor}`` dicts of
``utils.checkpoint.load_flat``; the result loads with
``convert.from_jax.load_jax_params`` into the larger variant.
"""

from __future__ import annotations

import math

import torch

from ..ops.image import resize_cubic


def interpolate_pos_embed(pos, new_len):
    """(1, L, D) learned pos-embed -> (1, new_len, D) by a cubic grid
    resize.  L and new_len must both be square grids (ViT patch layout)."""
    pos = torch.as_tensor(pos)
    _, l, d = pos.shape
    if l == new_len:
        return pos
    g = int(round(math.sqrt(l)))
    ng = int(round(math.sqrt(new_len)))
    if g * g != l or ng * ng != new_len:
        raise ValueError(f'pos-embed lengths must be square grids; '
                         f'got {l} -> {new_len}')
    out = resize_cubic(pos.reshape(1, g, g, d), ng)
    return out.reshape(1, new_len, d).to(pos.dtype)


def _adapt(flat, keys, new_len):
    missing = [k for k in keys if k not in flat]
    if missing:
        raise KeyError(f'the tree has no {missing}')
    out = dict(flat)
    for key in keys:
        out[key] = interpolate_pos_embed(flat[key], new_len)
    return out


def adapt_vqmodel_resolution(flat, new_num_patches, prefix=''):
    """A VQModel tree trained at one grid -> the tree for
    ``new_num_patches`` (encoder + decoder pos-embeds interpolated,
    everything else shared)."""
    return _adapt(flat, [f'{prefix}encoder/pos_embed',
                         f'{prefix}decoder/pos_embed'], new_num_patches)


def adapt_pipeline_resolution(flat, new_num_tokens):
    """A stage-2 pipeline tree -> higher token count: the vqgan towers plus
    the conditional transformer's sequence pos-embed."""
    flat = adapt_vqmodel_resolution(flat, new_num_tokens, prefix='vqgan/')
    return _adapt(flat, ['transformer/pos_embed'], new_num_tokens)
