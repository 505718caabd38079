"""CLIP text and image towers (``paintmind_tpu/models/clip.py``).

Ports of the reference's open_clip embedders (paintmind/modules/encoder.py:
45-151, ViT-L-14 with laion2b weights):

  * ``CLIPTextTransformer`` / ``CLIPTextEmbedder``: token embedding + learned
    positions -> causal pre-LN transformer -> ``ln_final``;
    ``layer='last' | 'penultimate'`` selects how many resblocks run
    (encoder.py:63-71, 96-104).  ``clip_text_encode`` of the JAX package.
  * ``CLIPVisionTransformer`` / ``CLIPImageEmbedder``: cubic resize to 224
    -> patch embed (14) -> [CLS; patches] + positions -> ``ln_pre`` ->
    transformer -> the patch tokens (CLS dropped, no ``ln_post``: the
    reference's ``encode_with_transformer``, encoder.py:136-150).
    ``clip_image_encode`` of the JAX package.

Blocks are pre-LN multi-head attention (packed qkv with bias, the scale on q
before the product, softmax in fp32) and an exact-GELU MLP.  The attention is
plain PyTorch math, as the JAX package computes it outside any Pallas kernel
(K1 takes no causal mask).  LayerNorm statistics are fp32; weights stay fp32
and are cast to the activations' type per use, as in JAX.

The resize is the JAX package's ``jax.image.resize(..., 'cubic')``: a
separable Keys cubic (a = -0.5) that widens its kernel by the scale when it
downsamples (antialiasing), with JAX's edge weights.  It is not
``F.interpolate(mode='bicubic')`` (a = -0.75, no antialiasing).

``convert_clip_text`` / ``convert_clip_visual`` map open_clip state dicts
onto these modules; ``load_image_tower`` / ``save_image_tower`` read and
write the JAX package's ``.npz`` tower artifacts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import LayerNorm, Linear
from ..ops.image import resize_cubic
from .vqmodel import make_generator, patchify, resolve_device


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    context_length: int = 77


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    heads: int = 16
    layers: int = 24


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention`` math (packed qkv with bias, out
    projection) on (B, N, D) activations."""

    def __init__(self, width, heads, *, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj = Linear(width, 3 * width, device=device)
        self.out_proj = Linear(width, width, device=device)

    def forward(self, x, mask=None):
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = (t.reshape(b, n, self.heads, hd)
                   for t in self.in_proj(x).chunk(3, dim=-1))
        logits = torch.einsum('bnhd,bmhd->bhnm', (q * hd ** -0.5).float(),
                              k.float())
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum('bhnm,bmhd->bnhd', probs, v).reshape(b, n, d)
        return self.out_proj(out)


class ResidualBlock(nn.Module):
    def __init__(self, width, heads, *, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiheadAttention(width, heads, device=device)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp_fc = Linear(width, 4 * width, device=device)
        self.mlp_proj = Linear(4 * width, width, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        h = F.gelu(self.mlp_fc(self.ln_2(x)))  # exact, not quick
        return x + self.mlp_proj(h)


@torch.no_grad()
def _init_blocks_(blocks, width, g):
    """The JAX init's scheme: normal kernels scaled by width^-0.5, zero
    biases, unit LayerNorms (the numbers are torch's, not jax.random's)."""
    for m in blocks.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(generator=g).mul_(width ** -0.5)
            m.bias.zero_()


# ---------------------------------------------------------------------------
# Text tower
# ---------------------------------------------------------------------------

class CLIPTextTransformer(nn.Module):
    """``forward(token_ids, layer)``: (B, 77) ints -> (B, 77, width) token
    features (reference encoder.py:90-104: causal mask, one block fewer for
    'penultimate', then ``ln_final``)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(), *, device=None,
                 seed=0):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width,
                                            device=device)
        self.positional_embedding = nn.Parameter(torch.empty(
            cfg.context_length, cfg.width, device=device))
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.width, cfg.heads, device=device)
            for _ in range(cfg.layers))
        self.ln_final = LayerNorm(cfg.width, device=device)
        if self.positional_embedding.is_meta:  # shapes only, to be loaded
            return
        g = make_generator(self.positional_embedding.device, seed)
        with torch.no_grad():
            self.token_embedding.weight.normal_(generator=g).mul_(0.02)
            self.positional_embedding.normal_(generator=g).mul_(0.01)
        _init_blocks_(self.resblocks, cfg.width, g)

    def forward(self, token_ids, layer='last', dtype=torch.float32):
        x = self.token_embedding.weight[token_ids.long()].to(dtype)
        x = x + self.positional_embedding.to(dtype)
        n = x.shape[1]
        mask = torch.full((n, n), -torch.inf, device=x.device).triu(1)
        stop = len(self.resblocks) - (1 if layer == 'penultimate' else 0)
        for block in self.resblocks[:stop]:
            x = block(x, mask)
        return self.ln_final(x)


# ---------------------------------------------------------------------------
# Visual tower
# ---------------------------------------------------------------------------

class CLIPVisionTransformer(nn.Module):
    """``forward(images)``: (B, H, W, 3) in [-1, 1] -> (B, grid², width)
    patch tokens (reference encoder.py:125-150: cubic resize to 224, CLS
    dropped, no ``ln_post``)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), *,
                 device=None, seed=0):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = Linear(cfg.patch_size ** 2 * 3, cfg.width, bias=False,
                            device=device)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width,
                                                        device=device))
        self.positional_embedding = nn.Parameter(torch.empty(
            grid * grid + 1, cfg.width, device=device))
        self.ln_pre = LayerNorm(cfg.width, device=device)
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.width, cfg.heads, device=device)
            for _ in range(cfg.layers))
        if self.class_embedding.is_meta:  # shapes only, to be loaded
            return
        g = make_generator(self.class_embedding.device, seed)
        s = cfg.width ** -0.5
        with torch.no_grad():
            self.conv1.weight.normal_(generator=g).mul_(s)
            self.class_embedding.normal_(generator=g).mul_(s)
            self.positional_embedding.normal_(generator=g).mul_(s)
        _init_blocks_(self.resblocks, cfg.width, g)

    def forward(self, images, dtype=torch.float32):
        cfg = self.cfg
        b = images.shape[0]
        if images.shape[1] != cfg.image_size:
            images = resize_cubic(images, cfg.image_size)
        x = patchify(images.to(dtype), cfg.patch_size)
        x = self.conv1(x)
        cls = self.class_embedding.to(dtype).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        for block in self.resblocks:
            x = block(x)
        return x[:, 1:]


# ---------------------------------------------------------------------------
# Converters (open_clip state_dict layout -> these modules)
# ---------------------------------------------------------------------------

# (this package's leaf, open_clip's leaf) in every resblock
_RESBLOCK_LEAVES = (
    ('ln_1.weight', 'ln_1.weight'), ('ln_1.bias', 'ln_1.bias'),
    ('attn.in_proj.weight', 'attn.in_proj_weight'),
    ('attn.in_proj.bias', 'attn.in_proj_bias'),
    ('attn.out_proj.weight', 'attn.out_proj.weight'),
    ('attn.out_proj.bias', 'attn.out_proj.bias'),
    ('ln_2.weight', 'ln_2.weight'), ('ln_2.bias', 'ln_2.bias'),
    ('mlp_fc.weight', 'mlp.c_fc.weight'), ('mlp_fc.bias', 'mlp.c_fc.bias'),
    ('mlp_proj.weight', 'mlp.c_proj.weight'),
    ('mlp_proj.bias', 'mlp.c_proj.bias'))


def _copy(t):
    return torch.as_tensor(t).detach().clone()


def _conv_resblocks(sd, prefix):
    out, i = {}, 0
    while f'{prefix}transformer.resblocks.{i}.ln_1.weight' in sd:
        theirs = f'{prefix}transformer.resblocks.{i}.'
        for ours, leaf in _RESBLOCK_LEAVES:
            out[f'resblocks.{i}.{ours}'] = _copy(sd[theirs + leaf])
        i += 1
    return out


def convert_clip_text(sd, prefix=''):
    """open_clip text state dict -> ``CLIPTextTransformer`` state dict."""
    out = _conv_resblocks(sd, prefix)
    for name in ('token_embedding.weight', 'positional_embedding',
                 'ln_final.weight', 'ln_final.bias'):
        out[name] = _copy(sd[prefix + name])
    return out


def convert_clip_visual(sd, prefix='visual.'):
    """open_clip visual state dict -> ``CLIPVisionTransformer`` state dict;
    the (width, 3, p, p) patch convolution becomes a (width, p·p·3) linear
    weight in ``patchify``'s (p1, p2, c) order."""
    out = _conv_resblocks(sd, prefix)
    conv = _copy(sd[prefix + 'conv1.weight'])
    out['conv1.weight'] = conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1)
    for name in ('class_embedding', 'positional_embedding', 'ln_pre.weight',
                 'ln_pre.bias'):
        out[name] = _copy(sd[prefix + name])
    return out


# ---------------------------------------------------------------------------
# Embedders: the reference call contracts
# ---------------------------------------------------------------------------

class CLIPTextEmbedder:
    """Reference call contract (encoder.py:45-104): tokenized text ->
    (B, 77, width); needs an open_clip tokenizer or precomputed ids.
    ``model``: a ``CLIPTextTransformer`` (seeded random weights when None).
    Frozen, on ``device``."""

    def __init__(self, model=None, cfg=CLIPTextConfig(), layer='last',
                 tokenizer=None, dtype=torch.float32, seed=0, device='cuda'):
        if layer not in ('last', 'penultimate'):
            raise ValueError(f"layer must be 'last' or 'penultimate', got {layer!r}")
        self.device = resolve_device(device)
        self.cfg, self.layer, self.tokenizer, self.dtype = cfg, layer, tokenizer, dtype
        if model is None:
            model = CLIPTextTransformer(cfg, device=self.device, seed=seed)
        self.model = model.to(self.device).requires_grad_(False).eval()

    @torch.no_grad()
    def __call__(self, text):
        if isinstance(text, (list, tuple)) and text and isinstance(text[0], str):
            if self.tokenizer is None:
                raise RuntimeError(
                    'CLIPTextEmbedder built without a tokenizer (the CLIP '
                    'BPE vocab is an open_clip asset, unavailable offline) '
                    '— pass pre-tokenized (B, 77) int ids, or construct '
                    'with tokenizer=open_clip.tokenize')
            text = self.tokenizer(list(text))
        ids = torch.as_tensor(np.asarray(text) if not isinstance(
            text, torch.Tensor) else text, device=self.device)
        return self.model(ids, self.layer, dtype=self.dtype)

    encode = __call__


class CLIPImageEmbedder:
    """Reference call contract (encoder.py:107-151): (B, H, W, 3) images in
    [-1, 1] -> (B, 256, width) patch tokens.  ``model``: a
    ``CLIPVisionTransformer`` (seeded random weights when None).  Frozen, on
    ``device``; activations in ``dtype``."""

    def __init__(self, model=None, cfg=CLIPVisionConfig(), dtype=torch.float32,
                 seed=0, device='cuda'):
        self.device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        if model is None:
            model = CLIPVisionTransformer(cfg, device=self.device, seed=seed)
        self.model = model.to(self.device).requires_grad_(False).eval()

    @torch.no_grad()
    def __call__(self, images):
        x = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images, device=self.device)
        return self.model(x, dtype=self.dtype)

    encode = __call__


def load_image_tower(path, dtype=torch.float32, heads=None, device='cuda'):
    """Rebuild a ``CLIPImageEmbedder`` from the JAX package's ``.npz`` tower
    artifact (``save_image_tower`` of either package, e.g. the ``tower.npz``
    of tools/train_imgvar.py).  Layers, width, patch and grid come from the
    parameter shapes; the head count from ``heads``, else the artifact's
    ``__cfg__/heads``, else the ViT convention width // 64."""
    from ..convert.from_jax import load_tower_params
    from ..utils.checkpoint import load_flat
    flat = load_flat(path)
    layer_ids = [int(k.split('/')[1]) for k in flat if k.startswith('resblocks/')]
    if not layer_ids:
        raise ValueError(f'{path}: no resblocks/* entries — not a '
                         'CLIPImageEmbedder artifact')
    width = int(flat['class_embedding'].shape[0])
    patch = int(round((flat['conv1'].shape[0] // 3) ** 0.5))
    grid = int(round((flat['positional_embedding'].shape[0] - 1) ** 0.5))
    if heads is None:
        heads = (int(flat['__cfg__/heads']) if '__cfg__/heads' in flat
                 else max(width // 64, 1))
    cfg = CLIPVisionConfig(image_size=patch * grid, patch_size=patch,
                           width=width, heads=heads, layers=1 + max(layer_ids))
    device = resolve_device(device)
    model = CLIPVisionTransformer(cfg, device='meta').to_empty(device=device)
    load_tower_params(model, {k: v for k, v in flat.items()
                              if not k.startswith('__cfg__')})
    return CLIPImageEmbedder(model, cfg=cfg, dtype=dtype, device=device)


def save_image_tower(path, tower):
    """Write a ``CLIPImageEmbedder`` in the JAX package's layout, with its
    head count as ``__cfg__/heads`` (the JAX ``load_image_tower`` reads it)."""
    from ..convert.from_jax import tower_to_flat
    from ..utils.checkpoint import save_params
    flat = tower_to_flat(tower.model)
    flat['__cfg__/heads'] = np.asarray(tower.cfg.heads, np.int32)
    return save_params(path, flat)
