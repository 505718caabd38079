"""SwiGLU feed-forward (``paintmind_tpu/nn/mlp.py``): a fused input
projection ``w12`` to 2·hidden features, ``silu(x1) * x2``, then ``w3``.

Tensor parallelism (``tp``): ``w12`` holds this rank's ``[w1_r | w2_r]``
rows and ``w3`` the matching input columns (row-parallel, summed over
'model')."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import enter, row_linear
from .core import Linear


def swiglu_hidden_dim(mlp_dim: int) -> int:
    """The requested width times 2/3, rounded up to a multiple of 8."""
    return (int(mlp_dim * 2 / 3) + 7) // 8 * 8


class SwiGLU(nn.Module):
    def __init__(self, dim, mlp_dim, *, device=None, dtype=None):
        super().__init__()
        hidden = swiglu_hidden_dim(mlp_dim)
        self.w12 = Linear(dim, 2 * hidden, device=device, dtype=dtype)
        self.w3 = Linear(hidden, dim, device=device, dtype=dtype)
        self.tp = None

    def forward(self, x):
        if self.tp is None:
            x1, x2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(x1) * x2)
        x1, x2 = self.w12(enter(x, self.tp)).chunk(2, dim=-1)
        return row_linear(self.w3, F.silu(x1) * x2, self.tp)
