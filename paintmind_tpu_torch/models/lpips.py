"""LPIPS perceptual distance (``paintmind_tpu/models/lpips.py``): a VGG16
backbone and learned linear heads, the ``lpips`` package's ``net='vgg'``
(reference paintmind/utils/trainer.py:14, 108-110, 214).

Input in [-1, 1] (NHWC at ``forward``, as in the JAX package), the
fixed channel shift and scale, VGG16 features after relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3, unit normalisation over the channels at every
location, squared difference, the 1×1 ``lin`` heads, the spatial mean, and
the sum over the five taps.

Weights: the JAX package's tree (``convs``: thirteen 3×3 HWIO kernels with
biases, ``lins``: five (1, 1, C, 1) kernels), from its ``.npz``
(``load_lpips``) or a live tree (``convert/from_jax.load_lpips_params``).
The repository ships no converted VGG weights; ``LPIPS(seed=...)`` is a
seeded random-VGG perceptual loss (a training signal, not the reference
objective), as the JAX package's ``init_lpips`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 feature config: channel widths per conv, 'M' = 2x2 max-pool
VGG16_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512]
TAP_AFTER_CONV = [2, 4, 7, 10, 13]  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
TAP_CHANNELS = [64, 128, 256, 512, 512]

# lpips ScalingLayer constants (input in [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """``convs`` (thirteen 3×3 convolutions) and ``lins`` (five per-channel
    head weights, (C,)); seeded random weights as ``init_lpips`` draws
    them (He-normal kernels, zero biases, |N(0, 1)| / C heads)."""

    def __init__(self, *, seed=0, device='cuda'):
        super().__init__()
        convs, cin = [], 3
        for c in VGG16_CFG:
            if c != 'M':
                convs.append(nn.Conv2d(cin, c, 3, padding=1, device=device))
                cin = c
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            nn.Parameter(torch.empty(c, device=device)) for c in TAP_CHANNELS)
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for conv in self.convs:
                fan_in = conv.in_channels * 9
                conv.weight.normal_(generator=g).mul_(math.sqrt(2.0 / fan_in))
                conv.bias.zero_()
            for lin in self.lins:
                lin.normal_(generator=g).abs_().div_(lin.numel())
        self.requires_grad_(False)  # a fixed metric: gradients flow to x only

    def _features(self, x):
        feats, i = [], 0
        for c in VGG16_CFG:
            if c == 'M':
                x = F.max_pool2d(x, 2, 2)
                continue
            conv = self.convs[i]
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype),
                                conv.bias.to(x.dtype), padding=1))
            i += 1
            if i in TAP_AFTER_CONV:
                feats.append(x)
        return feats

    def forward(self, x, y):
        """x, y: (B, H, W, 3) in [-1, 1] -> (B,) perceptual distances."""
        shift = torch.as_tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.as_tensor(_SCALE, dtype=x.dtype, device=x.device)
        fx = self._features(((x - shift) / scale).permute(0, 3, 1, 2))
        fy = self._features(((y - shift) / scale).permute(0, 3, 1, 2))
        total = 0.0
        for a, b, lin in zip(fx, fy, self.lins):
            d = torch.square(_unit_normalize(a.float())
                             - _unit_normalize(b.float()))
            total = total + torch.mean(
                torch.sum(d * lin.float().view(1, -1, 1, 1), dim=1), dim=(1, 2))
        return total


def _unit_normalize(x, eps=1e-10):
    """Over the channels (dim 1 of NCHW)."""
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps)


def convert_lpips(torch_lpips_module):
    """The ``lpips`` package's ``LPIPS(net='vgg')`` module -> the JAX
    package's LPIPS tree (``convs``: HWIO kernels and biases, ``lins``:
    (1, 1, C, 1) kernels), as CPU tensors; the port's
    ``paintmind_tpu/models/lpips.py:convert_lpips``."""
    sd = {k: v.detach().cpu().clone()
          for k, v in torch_lpips_module.state_dict().items()}

    # lpips stores vgg as net.slice<N>.<torch_seq_idx>.*; order numerically
    def sort_key(k):
        parts = k.split('.')
        return (int(parts[1][len('slice'):]), int(parts[2]))

    slice_keys = sorted((k for k in sd
                         if k.startswith('net.slice') and k.endswith('.weight')),
                        key=sort_key)
    convs = [{'kernel': sd[k].permute(2, 3, 1, 0).contiguous(),
              'bias': sd[k.replace('.weight', '.bias')]} for k in slice_keys]
    lins = [{'kernel': sd[f'lin{i}.model.1.weight'].permute(2, 3, 1, 0)
             .contiguous()} for i in range(len(TAP_CHANNELS))]
    return {'convs': convs, 'lins': lins}


def load_lpips(path, *, device='cuda'):
    """An LPIPS module from the JAX package's ``.npz`` (``convs/<i>/kernel``,
    ``convs/<i>/bias``, ``lins/<i>/kernel``)."""
    from ..convert.from_jax import load_lpips_params
    from ..utils.checkpoint import load_flat
    return load_lpips_params(LPIPS(device=device), load_flat(path))
