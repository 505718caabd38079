"""Evaluation metrics (``paintmind_tpu/utils/metrics.py``): PSNR / MAE / MSE
on images in [-1, 1], and codebook utilisation and perplexity, which
``VQGANTrainer.evaluate`` logs.  FID and rFID need InceptionV3 features,
which the port does not compute yet (ROADMAP queue A item 11)."""

from __future__ import annotations

import numpy as np
import torch


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def mae(a, b):
    return float(np.mean(np.abs(_f32(a) - _f32(b))))


def mse(a, b):
    return float(np.mean(np.square(_f32(a) - _f32(b))))


def psnr(a, b, data_range=2.0):
    """PSNR for images in [-1, 1] (data_range=2)."""
    m = mse(a, b)
    if m == 0:
        return float('inf')
    return float(10.0 * np.log10(data_range ** 2 / m))


def codebook_stats(indices, n_embed):
    """Utilisation fraction and perplexity of code usage."""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    counts = np.bincount(np.asarray(indices).reshape(-1), minlength=n_embed)
    probs = counts / max(counts.sum(), 1)
    nz = probs[probs > 0]
    perplexity = float(np.exp(-np.sum(nz * np.log(nz)))) if nz.size else 0.0
    return {'usage': float((counts > 0).mean()), 'perplexity': perplexity}


def fid(*args, **kwargs):
    from ..models.pipeline import _not_ported
    raise _not_ported('FID (InceptionV3 features)', 11)


def rfid(*args, **kwargs):
    from ..models.pipeline import _not_ported
    raise _not_ported('rFID (InceptionV3 features)', 11)
