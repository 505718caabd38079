"""Batched image preprocessing on the device (``paintmind_tpu/ops/image.py``):
resize -> crop (+ flip) -> normalize to [-1, 1], the reference's
``stage1_transform`` / ``stage2_transform`` (paintmind/utils/transform.py)
on a whole (B, H, W, C) batch of a device tensor.

The resize is ``jax.image.resize``'s: a separable product per axis with
the weights of its ``compute_weight_mat`` (no translation, antialiased
when it shrinks: the kernel widens by the shrink factor), for two kernels:
``'cubic'`` (Keys, a = -0.5) and ``'linear'`` (the triangle ``max(0, 1 -
|x|)``, JAX's ``'bilinear'``).  ``F.interpolate``'s bicubic (a = -0.75)
and its non-antialiased bilinear are other functions.

Crops and flips are one gather with explicit per-sample ``tops``, ``lefts``
and ``flips`` (``crop``), so a test can hold it against JAX's ``_crop_one``
on the same offsets; ``batched_transform`` draws them from a
``torch.Generator`` on the images' device.
"""

from __future__ import annotations

import numpy as np
import torch

RESIZE_METHODS = ('cubic', 'linear')


def _keys_cubic(x):
    """The Keys cubic kernel with a = -0.5 at |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros((), device=x.device), out)


def _triangle(x):
    return torch.clamp(1.0 - x, min=0.0)


def resize_weights(n_in, n_out, device=None, method='cubic'):
    """(n_in, n_out) fp32 weights of one axis of ``jax.image.resize(...,
    method)`` (``compute_weight_mat``, antialiased, no translation)."""
    if method not in RESIZE_METHODS:
        raise ValueError(f'resize method must be one of {RESIZE_METHODS}, '
                         f'got {method!r}')
    kernel = _keys_cubic if method == 'cubic' else _triangle
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)  # widen the kernel to downsample
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros((), device=device))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros((), device=device))


def resize(images, size, method='cubic'):
    """(B, H, W, C) -> (B, size, size, C) fp32, as ``jax.image.resize(images,
    (B, size, size, C), method)`` (``'cubic'`` or ``'linear'``): one
    separable product per axis that changes."""
    images = images.float()
    _, h, w, _ = images.shape
    if h != size:
        images = torch.einsum('bhwc,hy->bywc', images,
                              resize_weights(h, size, images.device, method))
    if w != size:
        images = torch.einsum('bywc,wx->byxc', images,
                              resize_weights(w, size, images.device, method))
    return images


def resize_cubic(images, size):
    return resize(images, size, 'cubic')


def crop(images, tops, lefts, size, flips=None):
    """Per-sample ``size``² crops of (B, H, W, C) at (``tops``, ``lefts``),
    each mirrored left-right where ``flips`` is true: one gather (JAX's
    vmapped ``_crop_one`` and ``x[:, :, ::-1]``)."""
    b = images.shape[0]
    ar = torch.arange(size, device=images.device)
    rows = tops.to(images.device).long()[:, None] + ar
    cols = ar if flips is None else torch.where(
        flips.to(images.device).bool()[:, None], size - 1 - ar, ar)
    cols = lefts.to(images.device).long()[:, None] + cols
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images[bi, rows[:, :, None], cols[:, None, :]]


def draw_crops(b, max_off, generator=None, device=None, hflip=True):
    """(tops, lefts, flips) for ``b`` samples, uniform on [0, max_off] and
    fair flips (None without ``hflip``), from ``generator`` on ``device``."""
    tops = torch.randint(0, max_off + 1, (b,), generator=generator,
                         device=device)
    lefts = torch.randint(0, max_off + 1, (b,), generator=generator,
                          device=device)
    flips = (torch.rand(b, generator=generator, device=device) < 0.5
             if hflip else None)
    return tops, lefts, flips


def batched_transform(imgs, generator=None, *, img_size=256, scale=0.8,
                      is_train=True, hflip=True, dtype=torch.float32,
                      tops=None, lefts=None, flips=None):
    """imgs: (B, H, W, C) uint8 (or float in [0, 255]) on any device ->
    (B, img_size, img_size, C) in [-1, 1], on that device.

    Cubic resize to (img_size / scale)² (aspect not kept, as the
    reference's tuple Resize), then a random crop and, with ``hflip``, a
    random horizontal flip (train) or the center crop (eval).  The train
    crop's ``tops``, ``lefts`` and ``flips`` are drawn from ``generator``
    unless given."""
    b = imgs.shape[0]
    size = int(img_size / scale)
    x = imgs.float() / 255.0
    x = torch.clamp(resize(x, size, 'cubic'), 0.0, 1.0)
    max_off = size - img_size
    if is_train:
        if tops is None:
            tops, lefts, drawn = draw_crops(b, max_off, generator, x.device,
                                            hflip)
            flips = drawn if flips is None else flips
        x = crop(x, tops, lefts, img_size, flips if hflip else None)
    else:
        off = max_off // 2
        x = x[:, off:off + img_size, off:off + img_size, :]
    return (x * 2.0 - 1.0).to(dtype)


def stage1_transform_device(imgs, generator=None, img_size=256,
                            is_train=True, scale=0.8, dtype=torch.float32):
    """The device-side ``stage1_transform`` (resize, crop, flip,
    normalize)."""
    return batched_transform(imgs, generator, img_size=img_size, scale=scale,
                             is_train=is_train, hflip=True, dtype=dtype)


def stage2_transform_device(imgs, generator=None, img_size=256,
                            is_train=True, scale=0.8, dtype=torch.float32):
    """The device-side ``stage2_transform``: no flip (text-image
    alignment)."""
    return batched_transform(imgs, generator, img_size=img_size, scale=scale,
                             is_train=is_train, hflip=False, dtype=dtype)
