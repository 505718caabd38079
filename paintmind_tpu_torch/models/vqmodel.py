"""Stage-1 ViT-VQGAN: encoder -> quantise -> decoder
(``paintmind_tpu/models/vqmodel.py``).

  encode: patchify -> patch-embed -> +pos -> pre-LN -> depth x block ->
          prev_quant (dim -> 32) -> l2-VQ (kernel K2)
  decode: post_quant (32 -> dim) -> +pos -> depth x block -> LN -> proj ->
          un-patchify -> clip(-1, 1)

Images are NHWC, as in the JAX package; the patch-embed convolution
(kernel = stride = patch, no bias) is a reshape plus one linear layer.

Two halves, as the JAX package's pure functions and its ``VQModel`` class:
the functions ``encode``, ``decode`` and ``forward`` run with gradient (the
stage-1 train step differentiates through them; dropout in training mode
from an explicit generator, ``remat`` per block), and the ``VQModel``
methods of the same names are their inference entry points, under
``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..nn.core import LayerNorm, Linear, fan_in_uniform_, init_module_
from ..nn.transformer import make_stack, stack_apply
from .quantize import Quantizer


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 256
    patch_size: int = 8
    dim: int = 512
    depth: int = 8
    num_head: int = 8
    mlp_dim: int = 2048
    channels: int = 3
    dim_head: int = 64
    dropout: float = 0.0

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                'Image dimensions must be divisible by the patch size '
                f'(image_size={self.image_size}, patch_size={self.patch_size})')

    @property
    def grid(self):
        return self.image_size // self.patch_size

    @property
    def num_patches(self):
        return self.grid ** 2


@dataclasses.dataclass(frozen=True)
class VQModelConfig:
    n_embed: int = 8192
    embed_dim: int = 32
    beta: float = 0.25
    enc: ViTConfig = ViTConfig()
    dec: ViTConfig = ViTConfig()

    @classmethod
    def from_dict(cls, d):
        def vit(sub, channel_key):
            return ViTConfig(
                image_size=sub['image_size'], patch_size=sub['patch_size'],
                dim=sub['dim'], depth=sub['depth'], num_head=sub['num_head'],
                mlp_dim=sub['mlp_dim'], channels=sub.get(channel_key, 3),
                dim_head=sub.get('dim_head', 64), dropout=sub.get('dropout', 0.0))
        d = d if isinstance(d, dict) else d.to_dict()
        return cls(n_embed=d['n_embed'], embed_dim=d['embed_dim'],
                   beta=d['beta'], enc=vit(d['enc'], 'in_channels'),
                   dec=vit(d['dec'], 'out_channels'))


def patchify(x, patch):
    """(B, H, W, C) -> (B, h·w, p·p·C) in (p1, p2, c) order."""
    b, hh, ww, c = x.shape
    h, w = hh // patch, ww // patch
    x = x.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def unpatchify(x, patch, grid, channels):
    """(B, h·w, p·p·C) -> (B, H, W, C); inverse of :func:`patchify`."""
    b = x.shape[0]
    x = x.reshape(b, grid, grid, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid * patch, grid * patch, channels)


def resolve_device(device):
    """The entry points' device rule: the card unless the caller asks for
    the CPU; a CUDA device with no card raises instead of falling back."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'paintmind_tpu_torch runs on a CUDA device by default and no GPU '
            "is available here: pass device='cpu' to run on the CPU")
    return device


def make_generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


class Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_size ** 2 * cfg.channels, cfg.dim,
                                  bias=False, **kw)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, cfg.dim,
                                                  **kw))
        self.norm_pre = LayerNorm(cfg.dim, **kw)
        self.layers = make_stack(cfg.depth, cfg.dim, dim_head=cfg.dim_head,
                                 mlp_dim=cfg.mlp_dim, num_head=cfg.num_head,
                                 dropout=cfg.dropout, **kw)

    def forward(self, x, *, backend=None, generator=None, remat=False):
        x = self.patch_embed(patchify(x, self.cfg.patch_size))
        x = self.norm_pre(x + self.pos_embed.to(x.dtype))
        return stack_apply(self.layers, x, backend=backend,
                           generator=generator, remat=remat)


class Decoder(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, cfg.dim,
                                                  **kw))
        self.layers = make_stack(cfg.depth, cfg.dim, dim_head=cfg.dim_head,
                                 mlp_dim=cfg.mlp_dim, num_head=cfg.num_head,
                                 dropout=cfg.dropout, **kw)
        self.norm = LayerNorm(cfg.dim, **kw)
        self.proj = Linear(cfg.dim, cfg.patch_size ** 2 * cfg.channels, **kw)

    def forward(self, x, *, backend=None, generator=None, remat=False):
        x = stack_apply(self.layers, x + self.pos_embed.to(x.dtype),
                        backend=backend, generator=generator, remat=remat)
        x = self.proj(self.norm(x))
        c = self.cfg
        return unpatchify(x, c.patch_size, c.grid, c.channels)


def encode(model, img, *, generator=None, backend=None, vq_backend='auto',
           remat=False):
    """(B, H, W, C) images in [-1, 1], in the compute type -> (z_q,
    commitment loss, int32 ids), with gradient (``paintmind_tpu``'s
    ``vm.encode``).  Dropout applies when ``model`` is in training mode,
    with masks from ``generator``; ``remat`` recomputes each block in the
    backward pass."""
    x = model.encoder(img, backend=backend, generator=generator, remat=remat)
    return model.quantize(model.prev_quant(x), model.config.beta,
                          backend=vq_backend)


def decode(model, z, *, generator=None, backend=None, remat=False):
    """(B, L, embed_dim) codes -> images in [-1, 1], NHWC, with gradient
    (``vm.decode``)."""
    x = model.decoder(model.post_quant(z), backend=backend,
                      generator=generator, remat=remat)
    return torch.clamp(x, -1.0, 1.0)


def forward(model, img, *, generator=None, backend=None, vq_backend='auto',
            remat=False):
    """-> (reconstruction, commitment loss), with gradient (``vm.forward``)."""
    z, loss, _ = encode(model, img, generator=generator, backend=backend,
                        vq_backend=vq_backend, remat=remat)
    return decode(model, z, generator=generator, backend=backend,
                  remat=remat), loss


def _as_nhwc(img, device):
    """Accept NHWC (native) or NCHW (reference convention), numpy or torch;
    add the batch dim."""
    img = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor)
                          else img, device=device)
    if img.ndim == 3:
        img = img[None]
    if img.shape[-1] not in (1, 3) and img.shape[1] in (1, 3):
        img = img.permute(0, 2, 3, 1)
    return img


class VQModel(nn.Module):
    """Stage-1 tokenizer with the JAX package's object API: ``encode``,
    ``decode``, ``forward``, ``reconstruct``, ``decode_from_indice``,
    ``freeze``, ``from_pretrained``, ``save_pretrained``, ``num_params``.
    Built in eval mode (no dropout), as the JAX package's methods run; the
    module functions ``encode`` / ``decode`` / ``forward`` above are the
    training path."""

    def __init__(self, config, *, seed=0, param_dtype=torch.float32,
                 compute_dtype=None, device='cuda'):
        super().__init__()
        self.config = (config if isinstance(config, VQModelConfig)
                       else VQModelConfig.from_dict(config))
        cfg = self.config
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        kw = dict(device=device, dtype=param_dtype)
        self.encoder = Encoder(cfg.enc, **kw)
        self.decoder = Decoder(cfg.dec, **kw)
        self.quantize = Quantizer(cfg.n_embed, cfg.embed_dim, **kw)
        self.prev_quant = Linear(cfg.enc.dim, cfg.embed_dim, **kw)
        self.post_quant = Linear(cfg.embed_dim, cfg.dec.dim, **kw)
        self._init_weights(make_generator(device, seed))
        self.eval()
        self.frozen = False

    @torch.no_grad()
    def _init_weights(self, g):
        init_module_(self, g)
        for vit in (self.encoder, self.decoder):
            vit.pos_embed.normal_(generator=g).mul_(vit.cfg.dim ** -0.5)
        fan_in_uniform_(self.encoder.patch_embed.weight, g)
        fan_in_uniform_(self.prev_quant.weight, g)
        fan_in_uniform_(self.post_quant.weight, g)
        self.quantize.codebook.normal_(generator=g)

    @property
    def device(self):
        return self.quantize.codebook.device

    def _prep(self, img):
        img = _as_nhwc(img, self.device)
        size = self.config.enc.image_size
        if img.shape[1] != size or img.shape[2] != size:
            raise ValueError(
                f'expected {size}x{size} images (config enc.image_size), '
                f'got input of shape {tuple(img.shape)}')
        if self.compute_dtype is not None:
            return img.to(self.compute_dtype)
        # no compute type set: a bf16 / fp16 batch keeps its type (the
        # parameters follow the activations), anything else runs in fp32
        if img.dtype in (torch.bfloat16, torch.float16):
            return img
        return img.float()

    @torch.no_grad()
    def encode(self, img, *, backend=None, vq_backend='auto'):
        """(B, H, W, C) images in [-1, 1] -> (z_q, commitment loss, ids)."""
        return encode(self, self._prep(img), backend=backend,
                      vq_backend=vq_backend)

    @torch.no_grad()
    def decode(self, z, *, backend=None):
        """(B, L, embed_dim) codes -> images in [-1, 1], NHWC."""
        z = torch.as_tensor(z, device=self.device)
        if self.compute_dtype is not None:
            z = z.to(self.compute_dtype)
        return decode(self, z, backend=backend)

    @torch.no_grad()
    def forward(self, img, *, backend=None, vq_backend='auto'):
        """-> (reconstruction, commitment loss)."""
        z, loss, _ = self.encode(img, backend=backend, vq_backend=vq_backend)
        return self.decode(z, backend=backend), loss

    def reconstruct(self, img, *, backend=None, vq_backend='auto'):
        return self.forward(img, backend=backend, vq_backend=vq_backend)[0]

    @torch.no_grad()
    def decode_from_indice(self, indices, *, backend=None):
        indices = torch.as_tensor(indices, device=self.device)
        return self.decode(self.quantize.decode_from_indice(indices),
                           backend=backend)

    def freeze(self):
        self.requires_grad_(False)
        self.frozen = True
        return self

    def from_pretrained(self, path):
        """Weights from the JAX package's ``.npz`` or a reference ``.pt`` /
        ``.pth`` / ``.bin`` state dict (``utils.checkpoint.load_flat``)."""
        from ..convert.from_jax import load_jax_params
        from ..utils.checkpoint import load_flat
        load_jax_params(self, load_flat(path, 'vqgan'))
        return self

    def save_pretrained(self, path):
        """Every parameter as a ``.npz`` in the JAX package's layout, which
        ``paintmind_tpu``'s ``VQModel.from_pretrained`` reads."""
        from ..convert.from_jax import to_flat
        from ..utils.checkpoint import save_params
        save_params(path, to_flat(self))
        return path

    @property
    def num_params(self):
        return sum(p.numel() for p in self.parameters())
