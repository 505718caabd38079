"""Image-grid rendering for trainer evaluation dumps (the port's own copy of
``paintmind_tpu/utils/image_grid.py``): the numpy/PIL equivalent
of torchvision make_grid/save_image as used by the reference evaluate()
hooks (trainer.py:281-282, 435-436: nrow=6, normalize to value_range
(-1, 1), 2px padding)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def make_grid(images, nrow=6, padding=2, value_range=(-1.0, 1.0)):
    """images: (N, H, W, C) float → (gh, gw, C) uint8 grid."""
    images = np.asarray(images, np.float32)
    lo, hi = value_range
    images = np.clip((images - lo) / (hi - lo), 0.0, 1.0)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), np.float32)
    for i in range(n):
        r, cl = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = cl * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return (grid * 255).astype(np.uint8)


def save_image_grid(images, path, nrow=6, value_range=(-1.0, 1.0)):
    grid = make_grid(images, nrow=nrow, value_range=value_range)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    Image.fromarray(grid).save(path)
    return path
