"""InceptionV3 pool3 feature extractor for rFID
(``paintmind_tpu/models/inception.py``): torchvision's ``Inception3``
feature path (conv stem -> towers A-E -> global average pool, 2048-d) at
full width, with a converter from a torchvision state dict.

Each ``BasicConv2d`` is a bias-free ``F.conv2d`` followed by BatchNorm
from running statistics (eps 1e-3) and ReLU, in fp32; max-pools are 3×3
stride 2 VALID, the towers' average pools 3×3 stride 1 padding 1 with the
padding counted (``count_include_pad=True``, torch's default, as JAX's
``reduce_window`` sum over 9).  ``preprocess`` maps [-1, 1] to [0, 1],
resizes to 299² as ``jax.image.resize(..., 'bilinear')`` does (the
triangle kernel, antialiased when it shrinks, e.g. from the 512² VQGAN's
images: not ``F.interpolate(antialias=False)``) and ImageNet-normalizes.

Without converted weights ``init_inception(generator)`` gives a fixed-seed
random-feature extractor, JAX's scheme (normal × √(2 / fan_in) kernels,
identity BatchNorm): rFID computed with it ("rfid-rand") is deterministic
and internally consistent, but not comparable to literature FID.  Its draws
are torch's, not ``jax.random``'s, so an rfid-rand value of this package
is comparable with other values of this package only, not with the JAX
package's rfid-rand.  Converted weights (``convert_inception`` of a
torchvision ``Inception_V3_Weights.IMAGENET1K_V1`` state dict, saved as
``.npz``) give torchvision-variant rFID ("rfid-inception") in both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize

BN_EPS = 1e-3
POOL3_DIM = 2048


def _a_spec(cin, pool):
    return {
        'branch1x1': (cin, 64, 1, 1),
        'branch5x5_1': (cin, 48, 1, 1), 'branch5x5_2': (48, 64, 5, 5),
        'branch3x3dbl_1': (cin, 64, 1, 1),
        'branch3x3dbl_2': (64, 96, 3, 3), 'branch3x3dbl_3': (96, 96, 3, 3),
        'branch_pool': (cin, pool, 1, 1),
    }


def _b_spec(cin):
    return {
        'branch3x3': (cin, 384, 3, 3),
        'branch3x3dbl_1': (cin, 64, 1, 1),
        'branch3x3dbl_2': (64, 96, 3, 3), 'branch3x3dbl_3': (96, 96, 3, 3),
    }


def _c_spec(cin, c7):
    return {
        'branch1x1': (cin, 192, 1, 1),
        'branch7x7_1': (cin, c7, 1, 1),
        'branch7x7_2': (c7, c7, 1, 7), 'branch7x7_3': (c7, 192, 7, 1),
        'branch7x7dbl_1': (cin, c7, 1, 1),
        'branch7x7dbl_2': (c7, c7, 7, 1), 'branch7x7dbl_3': (c7, c7, 1, 7),
        'branch7x7dbl_4': (c7, c7, 7, 1), 'branch7x7dbl_5': (c7, 192, 1, 7),
        'branch_pool': (cin, 192, 1, 1),
    }


def _d_spec(cin):
    return {
        'branch3x3_1': (cin, 192, 1, 1), 'branch3x3_2': (192, 320, 3, 3),
        'branch7x7x3_1': (cin, 192, 1, 1),
        'branch7x7x3_2': (192, 192, 1, 7), 'branch7x7x3_3': (192, 192, 7, 1),
        'branch7x7x3_4': (192, 192, 3, 3),
    }


def _e_spec(cin):
    return {
        'branch1x1': (cin, 320, 1, 1),
        'branch3x3_1': (cin, 384, 1, 1),
        'branch3x3_2a': (384, 384, 1, 3), 'branch3x3_2b': (384, 384, 3, 1),
        'branch3x3dbl_1': (cin, 448, 1, 1),
        'branch3x3dbl_2': (448, 384, 3, 3),
        'branch3x3dbl_3a': (384, 384, 1, 3),
        'branch3x3dbl_3b': (384, 384, 3, 1),
        'branch_pool': (cin, 192, 1, 1),
    }


# (name, (cin, cout, kh, kw) of a stem conv | a tower's {branch: dims})
_LAYOUT = [
    ('Conv2d_1a_3x3', (3, 32, 3, 3)),
    ('Conv2d_2a_3x3', (32, 32, 3, 3)),
    ('Conv2d_2b_3x3', (32, 64, 3, 3)),
    ('Conv2d_3b_1x1', (64, 80, 1, 1)),
    ('Conv2d_4a_3x3', (80, 192, 3, 3)),
    ('Mixed_5b', _a_spec(192, 32)),
    ('Mixed_5c', _a_spec(256, 64)),
    ('Mixed_5d', _a_spec(288, 64)),
    ('Mixed_6a', _b_spec(288)),
    ('Mixed_6b', _c_spec(768, 128)),
    ('Mixed_6c', _c_spec(768, 160)),
    ('Mixed_6d', _c_spec(768, 160)),
    ('Mixed_6e', _c_spec(768, 192)),
    ('Mixed_7a', _d_spec(768)),
    ('Mixed_7b', _e_spec(1280)),
    ('Mixed_7c', _e_spec(2048)),
]
_TOWER_KIND = {'Mixed_5b': 'a', 'Mixed_5c': 'a', 'Mixed_5d': 'a',
               'Mixed_6a': 'b', 'Mixed_6b': 'c', 'Mixed_6c': 'c',
               'Mixed_6d': 'c', 'Mixed_6e': 'c', 'Mixed_7a': 'd',
               'Mixed_7b': 'e', 'Mixed_7c': 'e'}


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm from running statistics + ReLU.  The
    kernel ``weight`` (OIHW) and the BatchNorm ``scale``, ``bias``,
    ``mean``, ``var`` are buffers: the extractor is never trained."""

    def __init__(self, cin, cout, kh, kw, *, device=None):
        super().__init__()
        self.register_buffer('weight', torch.empty(cout, cin, kh, kw,
                                                   device=device))
        self.register_buffer('scale', torch.ones(cout, device=device))
        self.register_buffer('bias', torch.zeros(cout, device=device))
        self.register_buffer('mean', torch.zeros(cout, device=device))
        self.register_buffer('var', torch.ones(cout, device=device))

    def forward(self, x, stride=1, padding=(0, 0)):
        y = F.conv2d(x, self.weight, stride=stride, padding=padding)
        inv = torch.rsqrt(self.var + BN_EPS)
        y = ((y - self.mean[:, None, None]) * inv[:, None, None]
             * self.scale[:, None, None] + self.bias[:, None, None])
        return F.relu(y)


class Tower(nn.Module):
    """One of the mixed blocks A-E; its branches are named as torchvision
    names them (``branch1x1``, ...)."""

    def __init__(self, kind, spec, *, device=None):
        super().__init__()
        self.kind = kind
        for name, dims in spec.items():
            self.add_module(name, BasicConv2d(*dims, device=device))

    def forward(self, x):
        return getattr(self, f'_forward_{self.kind}')(x)

    def _pool(self, x):
        return self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1,
                                             count_include_pad=True))

    def _forward_a(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x), padding=(2, 2))
        b3 = self.branch3x3dbl_1(x)
        b3 = self.branch3x3dbl_2(b3, padding=(1, 1))
        b3 = self.branch3x3dbl_3(b3, padding=(1, 1))
        return torch.cat([self.branch1x1(x), b5, b3, self._pool(x)], dim=1)

    def _forward_b(self, x):
        b3 = self.branch3x3(x, stride=2)
        bd = self.branch3x3dbl_1(x)
        bd = self.branch3x3dbl_2(bd, padding=(1, 1))
        bd = self.branch3x3dbl_3(bd, stride=2)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)

    def _forward_c(self, x):
        b7 = self.branch7x7_1(x)
        b7 = self.branch7x7_2(b7, padding=(0, 3))
        b7 = self.branch7x7_3(b7, padding=(3, 0))
        bd = self.branch7x7dbl_1(x)
        bd = self.branch7x7dbl_2(bd, padding=(3, 0))
        bd = self.branch7x7dbl_3(bd, padding=(0, 3))
        bd = self.branch7x7dbl_4(bd, padding=(3, 0))
        bd = self.branch7x7dbl_5(bd, padding=(0, 3))
        return torch.cat([self.branch1x1(x), b7, bd, self._pool(x)], dim=1)

    def _forward_d(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x), stride=2)
        b7 = self.branch7x7x3_1(x)
        b7 = self.branch7x7x3_2(b7, padding=(0, 3))
        b7 = self.branch7x7x3_3(b7, padding=(3, 0))
        b7 = self.branch7x7x3_4(b7, stride=2)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)

    def _forward_e(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3, padding=(0, 1)),
                        self.branch3x3_2b(b3, padding=(1, 0))], dim=1)
        bd = self.branch3x3dbl_1(x)
        bd = self.branch3x3dbl_2(bd, padding=(1, 1))
        bd = torch.cat([self.branch3x3dbl_3a(bd, padding=(0, 1)),
                        self.branch3x3dbl_3b(bd, padding=(1, 0))], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self._pool(x)], dim=1)


# ImageNet normalization for the torchvision weights; inputs in [-1, 1]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(images, size=299):
    """(B, H, W, 3) in [-1, 1] -> resized, ImageNet-normalized (B, size,
    size, 3) fp32 (``jax.image.resize(..., 'bilinear')``)."""
    x = (images.float() + 1.0) / 2.0
    x = resize(x, size, 'linear')
    mean = torch.tensor(_IMAGENET_MEAN, device=x.device)
    std = torch.tensor(_IMAGENET_STD, device=x.device)
    return (x - mean) / std


class InceptionV3(nn.Module):
    """``forward(images)``: (B, H, W, 3) in [-1, 1] -> (B, 2048) pool3
    activations, fp32.  Built with empty kernels: fill them with
    ``init_inception_`` or the weight bridge."""

    def __init__(self, *, device=None):
        super().__init__()
        for name, spec in _LAYOUT:
            if isinstance(spec, tuple):
                self.add_module(name, BasicConv2d(*spec, device=device))
            else:
                self.add_module(name, Tower(_TOWER_KIND[name], spec,
                                            device=device))
        self.eval()

    @torch.no_grad()
    def forward(self, images):
        x = preprocess(images).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.Conv2d_1a_3x3(x, stride=2)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x, padding=(1, 1))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a',
                     'Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e',
                     'Mixed_7a', 'Mixed_7b', 'Mixed_7c'):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


@torch.no_grad()
def init_inception_(module, generator):
    """JAX's random-feature scheme on ``module``, in place: normal ×
    √(2 / fan_in) kernels, identity BatchNorm (the draws are
    ``generator``'s)."""
    for m in module.modules():
        if isinstance(m, BasicConv2d):
            cout, cin, kh, kw = m.weight.shape
            m.weight.normal_(generator=generator).mul_(
                math.sqrt(2.0 / (kh * kw * cin)))
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    return module


def init_inception(generator=None, *, device='cuda'):
    """The random-feature InceptionV3 (seed 0 when no generator is given):
    the documented rFID substitute when no converted weights exist."""
    from .vqmodel import make_generator, resolve_device
    device = resolve_device(device)
    generator = generator or make_generator(device, 0)
    return init_inception_(InceptionV3(device=device), generator)


def convert_inception(state_dict):
    """A torchvision ``Inception3`` state dict (tensors or arrays) -> the
    JAX package's nested tree of numpy arrays ({name: {kernel (HWIO),
    scale, bias, mean, var}}, towers one level deeper), which
    ``convert.from_jax.load_inception_params`` loads and the JAX package's
    ``load_inception`` reads from an ``.npz``.  Aux and fc entries are
    ignored."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in state_dict.items()}

    def basic(prefix):
        return {
            'kernel': sd[f'{prefix}.conv.weight'].transpose(2, 3, 1, 0),
            'scale': sd[f'{prefix}.bn.weight'],
            'bias': sd[f'{prefix}.bn.bias'],
            'mean': sd[f'{prefix}.bn.running_mean'],
            'var': sd[f'{prefix}.bn.running_var'],
        }

    params = {}
    for name, spec in _LAYOUT:
        if isinstance(spec, tuple):
            params[name] = basic(name)
        else:
            params[name] = {b: basic(f'{name}.{b}') for b in spec}
    return params


def load_inception(path, *, device='cuda'):
    """An ``InceptionV3`` from a converted ``.npz`` (the JAX layout)."""
    from ..convert.from_jax import load_inception_params
    from ..utils.checkpoint import load_flat
    from .vqmodel import resolve_device
    module = InceptionV3(device=resolve_device(device))
    return load_inception_params(module, load_flat(path))
