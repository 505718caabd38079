"""A device-resident dataset cache (``paintmind_tpu/utils/device_cache.py``):
the whole corpus is uploaded once to the card as uint8, and each step's
batch is gathered, cropped, flipped and normalized there.

Host work happens once, in the constructor: decode and PIL-bicubic resize
to the transform's pre-crop size, (img_size / scale)², the host
``stage1_transform``'s Resize step with its uint8 rounding, so the device
side's crop, flip and [-1, 1] normalization reproduce the host transform.
After that an epoch moves no pixel between host and card: a step gathers
its rows by a permutation slice (``ops.image.crop`` with the step's
offsets and flips) and yields a device tensor, which the trainers'
``train_step`` takes as it is (``torch.as_tensor`` on a tensor already on
the trainer's device and in fp32 copies nothing).

The loader's device defaults to the card; with no card that raises
(``device='cpu'`` keeps the cache in host memory, as the tests do).  Draws
come from a ``torch.Generator`` on that device, seeded per (seed, epoch):
each epoch reshuffles, and two loaders with one seed yield the same
batches.  ``epoch_plan(epoch)`` returns an epoch's permutation and every
step's crop offsets and flips, which is how a test holds a train batch
against ``ops.image.crop`` of the same draws.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.vqmodel import resolve_device
from ..ops.image import crop, draw_crops


def normalize(x, dtype=torch.float32):
    """uint8 pixels -> [-1, 1] in ``dtype``: x / 255 · 2 − 1 as the JAX
    package's compiled batch program computes it, the division by 255 a
    product with its fp32 reciprocal (XLA's rewrite of a division by a
    constant; the written division differs in the last bit on some
    pixels)."""
    return (x.float() * (1.0 / 255.0) * 2.0 - 1.0).to(dtype)


def _list_images(source):
    """Folder path or path list -> list of image paths (shared by the
    constructor and ``make_split_cache_loaders``)."""
    if isinstance(source, (list, tuple)):
        return [str(p) for p in source]
    return [os.path.join(str(source), f)
            for f in sorted(os.listdir(str(source)))
            if f.lower().endswith(('.jpg', '.jpeg', '.png'))]


class DeviceCacheLoader:
    """DataLoader-protocol iterable over a corpus cached on the device.

    ``source``: a folder path, a list of image paths, or an (N, H, W, 3)
    uint8 array already resized to (img_size / scale)².  Yields
    (B, img_size, img_size, 3) tensors in [-1, 1] on ``device`` (with
    ``return_indices``, (batch, corpus indices)).  ``drop_last=False``
    yields the last partial batch too: the fixed-size window ending at the
    epoch's last item, of which only the unseen suffix is kept, so every
    item comes once."""

    def __init__(self, source, batch_size, *, img_size=256, scale=0.8,
                 is_train=True, hflip=True, seed=0, dtype=torch.float32,
                 device='cuda', drop_last=True, return_indices=False):
        self.batch_size = int(batch_size)
        self.img_size = int(img_size)
        self.is_train = bool(is_train)
        self.hflip = bool(hflip)
        self.dtype = dtype
        self.drop_last = bool(drop_last)
        self.return_indices = bool(return_indices)
        self.seed = int(seed)
        self.epoch = 0
        resize = int(img_size / scale)

        if isinstance(source, np.ndarray):
            if source.dtype != np.uint8 or source.ndim != 4:
                raise ValueError('array source must be (N, H, W, 3) uint8')
            if source.shape[1] != resize or source.shape[2] != resize:
                raise ValueError(f'array source must be pre-resized to '
                                 f'({resize}, {resize}); got '
                                 f'{source.shape[1:3]}')
            stacked = source
        else:
            from PIL import Image
            paths = _list_images(source)
            if not paths:
                raise ValueError('no images to cache')
            rows = []
            for p in paths:  # host, once: decode + the reference Resize step
                img = Image.open(p).convert('RGB')
                rows.append(np.asarray(
                    img.resize((resize, resize), Image.BICUBIC), np.uint8))
            stacked = np.stack(rows)

        self.n = int(stacked.shape[0])
        if self.n < self.batch_size:
            raise ValueError(f'corpus ({self.n}) smaller than batch size '
                             f'({self.batch_size})')
        self.device = resolve_device(device)
        self._data = torch.from_numpy(np.ascontiguousarray(stacked)).to(
            self.device)  # the one upload

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _generator(self, epoch):
        # one stream per (seed, epoch), on the cache's device
        return torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + epoch)

    def epoch_plan(self, epoch):
        """(permutation (n,), [(tops, lefts, flips) per step]) of an epoch,
        on the device: the identity and no draws for an eval loader;
        ``flips`` is None without ``hflip``."""
        if not self.is_train:
            return torch.arange(self.n, device=self.device), [None] * len(self)
        g = self._generator(epoch)
        perm = torch.randperm(self.n, generator=g, device=self.device)
        max_off = self._data.shape[1] - self.img_size
        draws = [draw_crops(self.batch_size, max_off, g, self.device,
                            self.hflip) for _ in range(len(self))]
        return perm, draws

    def _batch(self, idx, draws):
        x = self._data[idx]  # gather on the device
        if self.is_train:
            tops, lefts, flips = draws
            x = crop(x, tops, lefts, self.img_size, flips)
        else:
            off = (x.shape[1] - self.img_size) // 2
            x = x[:, off:off + self.img_size, off:off + self.img_size, :]
        return normalize(x, self.dtype)

    def __iter__(self):
        perm, plan = self.epoch_plan(self.epoch)
        try:
            for step, draws in enumerate(plan):
                start = step * self.batch_size
                count = min(self.batch_size, self.n - start)
                s = start if count == self.batch_size \
                    else self.n - self.batch_size
                idx = perm[s:s + self.batch_size]
                out = self._batch(idx, draws)
                if count != self.batch_size:
                    out, idx = out[-count:], idx[-count:]
                yield (out, idx) if self.return_indices else out
        finally:
            self.epoch += 1

    @property
    def nbytes(self):
        return self._data.numel()  # uint8: bytes == elements


def split_image_paths(source, valid_size=32, seed=42):
    """The train/valid split rule (evaluations that re-derive the held-out
    set must call this): a seed-42 numpy permutation, valid = its first
    min(valid_size, max(N // 10, 1)) entries.  Returns (train_paths,
    valid_paths)."""
    paths = _list_images(source)
    if not paths:
        raise ValueError('no images to cache')
    perm = np.random.default_rng(seed).permutation(len(paths))
    valid_n = min(valid_size, max(len(paths) // 10, 1))
    return ([paths[i] for i in perm[valid_n:]],
            [paths[i] for i in perm[:valid_n]])


def make_split_cache_loaders(source, train_batch, valid_batch, *,
                             valid_size=32, seed=42, hflip=True,
                             img_size=256, dtype=torch.float32,
                             device='cuda'):
    """The deterministic train/valid split -> two ``DeviceCacheLoader``s on
    ``device`` (as ``native.fastloader.make_split_loaders``)."""
    train_paths, valid_paths = split_image_paths(source, valid_size, seed)
    valid_n = len(valid_paths)
    train = DeviceCacheLoader(train_paths, train_batch, img_size=img_size,
                              is_train=True, hflip=hflip, seed=seed,
                              dtype=dtype, device=device)
    valid = DeviceCacheLoader(valid_paths, min(valid_batch, valid_n),
                              img_size=img_size, is_train=False, seed=seed,
                              dtype=dtype, device=device, drop_last=False)
    print(f'device cache: {len(train_paths)} train / {valid_n} valid '
          f'images, {train.nbytes / 1e6:.0f} MB resident on {train.device}')
    return train, valid
