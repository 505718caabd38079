"""Evaluation metrics (``paintmind_tpu/utils/metrics.py``): PSNR / MAE / MSE
on images in [-1, 1], codebook utilisation and perplexity, which
``VQGANTrainer.evaluate`` logs, and FID: activation statistics and the
Fréchet distance in float64 numpy (scipy's ``sqrtm``, as the JAX package
computes them), over InceptionV3 pool3 features computed on the device
(``models/inception.py``), for rFID between real images and their
reconstructions."""

from __future__ import annotations

import os

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


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------

def activation_statistics(features):
    """features: (N, D) -> (mu, sigma), float64."""
    feats = np.asarray(_f32(features), np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """Fréchet distance between two Gaussians (the FID formula)."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # no disp=: scipy 1.18 removed it (the default returns the root alone)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid(real_features, fake_features):
    """FID between two (N, D) feature sets: InceptionV3 pool3 for rFID, or
    any embedding for a relative comparison."""
    mu1, s1 = activation_statistics(real_features)
    mu2, s2 = activation_statistics(fake_features)
    return frechet_distance(mu1, s1, mu2, s2)


_EXTRACTOR_CACHE = {}
DEFAULT_INCEPTION = os.path.join(os.path.dirname(__file__), '..', 'assets',
                                 'inception_v3.npz')


def inception_extractor(weights='auto', device='cuda'):
    """(features_fn: images -> (N, 2048) float32 numpy, variant).

    ``weights``: 'auto' = the converted InceptionV3 at
    ``paintmind_tpu_torch/assets/inception_v3.npz`` when it exists (this
    repository has none), else the seed-0 random-feature substitute
    ('rfid-rand': deterministic and internally consistent, not comparable
    to literature FID nor to the JAX package's rfid-rand, whose draws are
    ``jax.random``'s); a path loads that ``.npz`` ('rfid-inception').
    'auto' is resolved before the lookup, so an asset that appears later is
    picked up.  Memoized per (weights, device): ``rfid`` runs in training
    evaluations and must not rebuild the 24 M-parameter network each call.
    The features run on ``device`` in fp32 batches."""
    from ..models import inception as inc
    from ..models.vqmodel import resolve_device
    if weights == 'auto':
        weights = DEFAULT_INCEPTION if os.path.exists(DEFAULT_INCEPTION) \
            else None
    device = resolve_device(device)
    cache_key = (weights, str(device))
    if cache_key in _EXTRACTOR_CACHE:
        return _EXTRACTOR_CACHE[cache_key]
    if weights is None:
        net, variant = inc.init_inception(device=device), 'rfid-rand'
    else:
        net, variant = inc.load_inception(weights, device=device), \
            'rfid-inception'

    def features(images, batch=32):
        imgs = torch.as_tensor(_f32(images))
        out = [net(imgs[i:i + batch].to(device)).cpu().numpy()
               for i in range(0, imgs.shape[0], batch)]
        return np.concatenate(out, axis=0)

    _EXTRACTOR_CACHE[cache_key] = (features, variant)
    return features, variant


def rfid(real_images, fake_images, weights='auto', batch=32, device='cuda'):
    """Reconstruction FID between two sets of (N, H, W, 3) images in
    [-1, 1]; returns (value, variant): 'rfid-inception' with converted
    weights, 'rfid-rand' with the random-feature substitute."""
    features, variant = inception_extractor(weights, device)
    return fid(features(real_images, batch),
               features(fake_images, batch)), variant
