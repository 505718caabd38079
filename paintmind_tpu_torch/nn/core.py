"""Building blocks: linear, LayerNorm and RMSNorm with fp32 statistics,
rotary position embedding, initialisers.

Numerics policy (as in ``paintmind_tpu/nn/core.py``): a layer computes in
the dtype of its incoming activations, casting its own parameters to it,
except the norms' statistics, which always run in fp32.  ``LayerNorm`` keeps
them in fp32 inside one ``F.layer_norm`` call where its parameters are in
the activations' type (serving), and widens the activations to fp32 where
they are not (training: bf16 activations over fp32 master parameters).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling


class Linear(nn.Linear):
    """``nn.Linear`` whose parameters follow the activation dtype (JAX
    ``linear`` casts its kernel to ``x.dtype``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics, eps 1e-5, output in the input dtype.

    Where the weight and the bias are in the activations' type, one pass:
    ``F.layer_norm`` on the tensors as they are.  PyTorch's kernels keep the
    mean and rstd in fp32 for a bf16 or fp16 input, evaluate
    ``weight·rstd·(x − mean) + bias`` in fp32 and round once on the store,
    and no fp32 copy of the activations is written (counter
    ``pm.norm.one_pass``).  On the card the bits are the fp32 form's (the
    same Welford order for every input type); the CPU's reduced-type kernel
    sums in another order, within one ulp of it.  Otherwise the
    fp32 form: the activations widened to fp32, normalised with the
    parameters in fp32 and rounded back (counter ``pm.norm.fp32_copies``).
    Training takes it, with bf16 activations over fp32 master parameters:
    rounding the masters to bf16 would normalise with other values than
    the parameters the update holds."""

    def __init__(self, dim, *, device=None, dtype=None):
        super().__init__(dim, eps=1e-5, device=device, dtype=dtype)

    def forward(self, x):
        w, b = self.weight, self.bias
        one_pass = w.dtype == b.dtype == x.dtype
        if profiling.counting():
            profiling.count('pm.norm.one_pass' if one_pass
                            else 'pm.norm.fp32_copies', 1)
        if one_pass:
            return F.layer_norm(x, self.normalized_shape, w, b, self.eps)
        y = F.layer_norm(x.float(), self.normalized_shape, w.float(),
                         b.float(), self.eps)
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm (Zhang & Sennrich 2019, as in Qwen3 / SDAR): ``x /
    sqrt(mean(x²) + eps) · weight`` over the last axis, the statistics and
    the gain in fp32, the output rounded once to the input dtype
    (``F.rms_norm``: one pass on the card, as ``LayerNorm``'s
    ``F.layer_norm``)."""

    def __init__(self, dim, eps=1e-6, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight.shape, self.weight.to(x.dtype),
                          self.eps)


def rope_tables(positions, dim, theta, device=None):
    """(cos, sin), each (len(positions), dim) fp32, of the rotate-half
    rotary embedding (RoFormer; Hugging Face ``rotate_half``): frequency
    ``theta^(-2i/dim)`` for pair i, repeated over both halves; ``sin``'s
    first half negated, so that ``rotate_half(x)·sin`` is
    ``roll(x, dim/2)·sin`` with these tables (``ops/rope.py`` applies
    them)."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=device) / dim)
    pos = torch.as_tensor(positions, dtype=torch.float64, device=device)
    ang = pos[:, None] * inv[None]
    return (torch.cat([ang.cos()] * 2, dim=-1).float(),
            torch.cat([-ang.sin(), ang.sin()], dim=-1).float())


_rows = contextvars.ContextVar('paintmind_global_rows', default=None)


@contextlib.contextmanager
def global_rows(offset, total):
    """Under data parallelism: the per-row random draws inside (masking
    noise, dropout masks, the gradient penalty's mix) are the rows
    [offset, offset + b) of one draw for the ``total`` rows of the global
    batch, so every rank draws from the same generator what a single
    device would, and keeps its own rows."""
    token = _rows.set((int(offset), int(total)))
    try:
        yield
    finally:
        _rows.reset(token)


def rand_rows(shape, *, device=None, generator=None):
    """``torch.rand(shape)``, or this rank's rows of the global batch's
    draw inside ``global_rows``."""
    rows = _rows.get()
    if rows is None:
        return torch.rand(shape, device=device, generator=generator)
    offset, total = rows
    full = torch.rand((total,) + tuple(shape[1:]), device=device,
                      generator=generator)
    return full[offset:offset + shape[0]]


def dropout(x, rate, *, generator=None, training=False):
    """Inverted dropout (``paintmind_tpu/nn/core.py::dropout``): keep each
    element with probability ``1 - rate`` and scale the kept ones by
    ``1 / (1 - rate)``.  The keep-mask is drawn on ``x``'s device from
    ``generator`` (torch's default generator of that device when None).
    The identity when not training or when ``rate`` is 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


@torch.no_grad()
def xavier_uniform_(weight, generator):
    """Xavier-uniform for a torch (out, in) weight."""
    fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return weight.uniform_(-a, a, generator=generator)


@torch.no_grad()
def fan_in_uniform_(weight, generator):
    """torch's Conv2d default: uniform(±1/sqrt(fan_in))."""
    a = 1.0 / math.sqrt(weight.shape[1])
    return weight.uniform_(-a, a, generator=generator)


@torch.no_grad()
def init_module_(module, generator):
    """Seeded init of every layer below ``module``: xavier-uniform linear
    weights, zero biases, unit LayerNorm (the JAX package's scheme; the
    layers with another scheme re-initialise themselves afterwards)."""
    for m in module.modules():
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            xavier_uniform_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
