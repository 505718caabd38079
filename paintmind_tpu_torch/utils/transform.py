"""Host-side image preprocessing (PIL/numpy): the port's own copy of
``paintmind_tpu/utils/transform.py`` (reference transforms,
paintmind/utils/transform.py:7-34):

  stage1_transform: Resize((img_size/scale, img_size/scale), bicubic) →
                    RandomCrop + HFlip(0.5) (train) / CenterCrop (eval) →
                    ToTensor → Normalize(0.5, 0.5)  ⇒ float in [-1, 1]
  stage2_transform: same minus the horizontal flip (text-image alignment).

Output layout is HWC float32 (the models' NHWC batching); the reference
returns CHW torch tensors — the models accept both.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def pair(t):
    return t if isinstance(t, tuple) else (t, t)


class _Compose:
    """Callable transform: PIL.Image -> float32 HWC array in [-1, 1]."""

    def __init__(self, img_size, is_train, scale, hflip, rng=None):
        self.resize = pair(int(img_size / scale))
        self.img_size = pair(img_size)
        self.is_train = is_train
        self.hflip = hflip
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        if isinstance(img, np.ndarray):
            arr = img
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            img = Image.fromarray(arr)
        if img.mode != 'RGB':
            img = img.convert('RGB')
        # exact-size bicubic resize — reference passes a (h, w) tuple so
        # aspect ratio is NOT preserved (transform.py:10)
        img = img.resize((self.resize[1], self.resize[0]), Image.BICUBIC)
        w, h = img.size
        th, tw = self.img_size
        if self.is_train:
            top = int(self.rng.integers(0, h - th + 1))
            left = int(self.rng.integers(0, w - tw + 1))
        else:
            top = (h - th) // 2
            left = (w - tw) // 2
        img = img.crop((left, top, left + tw, top + th))
        if self.is_train and self.hflip and self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        x = np.asarray(img, dtype=np.float32) / 255.0
        return x * 2.0 - 1.0


def stage1_transform(img_size=256, is_train=True, scale=0.8, rng=None):
    return _Compose(img_size, is_train, scale, hflip=True, rng=rng)


def stage2_transform(img_size=256, is_train=True, scale=0.8, rng=None):
    return _Compose(img_size, is_train, scale, hflip=False, rng=rng)
