"""Vector quantiser with an l2-normalised codebook, inference half
(``paintmind_tpu/models/quantize.py``).

With both sides l2-normalised, ``argmin_j ||z - e_j||²`` equals
``argmax_j z·e_j``, which kernel K2 (``ops/vq_lookup``) computes without
writing the (tokens, 8192) score matrix.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.vq_lookup import fused_nearest_codes, nearest_codes_plain


def l2norm(x, eps=1e-12):
    """torch ``F.normalize`` semantics, x / max(||x||₂, eps), computed in
    fp32 and returned in the input dtype."""
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
    return (x32 / torch.clamp(n, min=eps)).to(x.dtype)


def nearest_codes(codebook_norm, z_norm, *, backend='auto'):
    """argmax_j z·e_j over the codebook; z_norm (..., D) -> int32 (...,).
    'auto': K2 on a CUDA tensor (the wrapper raises on what the
    kernel does not take), the plain version on a CPU tensor; 'plain': the
    plain version on any device."""
    if backend == 'plain':
        return nearest_codes_plain(z_norm, codebook_norm)
    if backend != 'auto':
        raise ValueError(f'vq backend {backend!r} not in auto|plain')
    return fused_nearest_codes(z_norm.float().contiguous(),
                               codebook_norm.float().contiguous())


class Quantizer(nn.Module):
    def __init__(self, n_embed, embed_dim, *, device=None, dtype=None):
        super().__init__()
        self.codebook = nn.Parameter(torch.empty(n_embed, embed_dim,
                                                 device=device, dtype=dtype))

    def forward(self, z, beta=0.25, *, backend='auto'):
        """Returns (z_q, commitment loss, int32 indices), as
        ``paintmind_tpu.models.quantize.quantize``: the loss is
        ``β·mean((sg(z_q) − z)²) + mean((z_q − sg(z))²)`` in fp32, so the
        encoder gets β of the distance's gradient and the codebook all of
        it; z_q is the straight-through ``z + sg(z_q − z)`` (its values
        round as the JAX package's do, its gradient goes to z)."""
        z = l2norm(z)
        e = l2norm(self.codebook.to(z.dtype))
        indices = nearest_codes(e.detach(), z.detach(), backend=backend)
        z_q = e[indices.long()]
        zf, qf = z.float(), z_q.float()
        loss = (beta * torch.mean(torch.square(qf.detach() - zf))
                + torch.mean(torch.square(qf - zf.detach())))
        return z + (z_q - z).detach(), loss, indices

    def decode_from_indice(self, indices):
        """Embed, then l2-normalise (reference quantize.py:40-44)."""
        return l2norm(self.codebook)[indices.long()]
