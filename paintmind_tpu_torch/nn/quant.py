"""Int8 post-training quantization of linear layers, for inference
(``paintmind_tpu/nn/quant.py``).

Two modes, chosen when quantizing:

  * ``w8``: weight-only.  The int8 kernel is cast to the activation dtype
    and multiplied there; the per-output-channel scale commutes with the
    contraction, so it is applied to the output.
  * ``w8a8``: the activations are also quantized, per token (dynamic
    symmetric abs-max, in fp32), the product is s8 x s8 -> s32, and the
    int32 accumulators are rescaled by (token scale x channel scale) in
    fp32 before the cast to the activation dtype.  On the card the product
    is ``torch._int_mm`` (cuBLASLt's int8 GEMM, the counterpart of XLA's
    ``dot_general`` with an int32 result); on the CPU an exact product in
    float64 (|x_q·w_q| ≤ 127² and K ≤ 2^36 keep every partial sum an
    integer below 2^53).  Nothing falls back to ``w8`` or to floating
    point: a shape the card's product refuses raises.

Weights: symmetric per output channel, scale ``amax / 127`` over the input
axis, round half to even (``torch.round``), clip to ±127.  Biases, norms
and embeddings stay in floating point.

``QLinear`` replaces a ``nn.core.Linear`` in place.  It holds the int8
``kernel_q`` (out, in), the fp32 ``scale`` (out,), the optional ``bias``
and, in ``w8a8``, the zero-size int8 buffer ``dyn``: the JAX package's
mode marker, which the weight bridge writes as ``dyn`` (``(depth, 0)``
under a depth-stacked ``layers`` node, ``(0,)`` elsewhere), so a quantized
checkpoint carries its mode in its key set as it does there.  The scale
stays fp32 whatever ``.to()`` or ``.half()`` asks of the module: bf16
scales would add ~0.4 % error on top of int8's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

QMODES = ('w8', 'w8a8')


def _check_mode(mode):
    if mode not in QMODES:
        raise ValueError(f'quantization mode must be one of {QMODES}, '
                         f'got {mode!r}')


@torch.no_grad()
def quantize_weight(weight, amax_reduce=None):
    """A weight (..., out, in) -> (int8 (..., out, in), fp32 scale
    (..., out)): ``amax / 127`` over the input axis, round half to even,
    clip to ±127.  A depth-stacked (depth, out, in) weight gets per-(depth,
    out) scales, as the JAX package's (depth, in, out) kernels do.
    ``amax_reduce``: the abs-max (..., out, 1) of this slice of the input
    axis -> that of the whole axis (a row-parallel slice's all-reduce MAX)."""
    w = weight.float()
    amax = w.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    # a true division on every device (a CUDA tensor divided by a Python
    # scalar is multiplied by its reciprocal instead), as the JAX package's
    # eager quantize_linear divides
    scale = torch.clamp(amax, min=1e-12) / torch.tensor(127.0,
                                                        device=w.device)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.squeeze(-1)


def int_mm_shape_error(m, k, n):
    """Why ``torch._int_mm`` refuses an (m, k) x (k, n) product, or None:
    more than 16 rows, and k and n positive multiples of 8."""
    if m <= 16:
        return f'{m} rows (it needs more than 16)'
    if k <= 0 or k % 8:
        return f'an inner dim of {k} (it needs a positive multiple of 8)'
    if n <= 0 or n % 8:
        return f'{n} output features (it needs a positive multiple of 8)'
    return None


def int8_matmul(xq, wq):
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exactly: ``torch._int_mm``
    on the card, with the kernel as the column-major (K, N) operand
    cuBLASLt's int8 GEMM takes; an exact float64 product on the CPU."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f'int8_matmul takes int8 operands, got {xq.dtype} '
                        f'and {wq.dtype}')
    m, k = xq.shape
    n = wq.shape[0]
    if xq.is_cuda:
        why = int_mm_shape_error(m, k, n)
        if why is not None:
            raise ValueError(f'w8a8: the card\'s int8 product '
                             f'(torch._int_mm) cannot take a ({m}, {k}) x '
                             f'({k}, {n}) product: {why}')
        return torch._int_mm(xq.contiguous(), wq.contiguous().t())
    return (xq.double() @ wq.double().t()).to(torch.int32)


def quantize_activations(x):
    """Per-token symmetric abs-max quantization in fp32: (int8 x_q, fp32
    token scale (..., 1)).  The token scale is ``amax`` times the fp32
    reciprocal of 127, as the JAX package's compiled ``linear_q`` computes
    ``amax / 127`` (and as CUDA divides a tensor by a scalar): one
    rounding rule on the card and the CPU."""
    x32 = x.float()
    sx = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-12) \
        * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def linear_q(x, kernel_q, scale, bias=None, *, mode):
    """A quantized linear on ``x`` (..., in) -> (..., out) in ``x``'s dtype,
    in ``paintmind_tpu/nn/quant.py::linear_q``'s order of operations."""
    _check_mode(mode)
    if mode == 'w8a8':
        xq, sx = quantize_activations(x)
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), kernel_q)
        acc = acc.reshape(*x.shape[:-1], kernel_q.shape[0])
        y = (acc.float() * sx * scale.float()).to(x.dtype)
    else:
        y = F.linear(x, kernel_q.to(x.dtype)) * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class QLinear(nn.Module):
    """An int8 linear (inference only; no parameter takes a gradient)."""

    def __init__(self, kernel_q, scale, bias=None, *, mode='w8a8'):
        super().__init__()
        _check_mode(mode)
        self.mode = mode
        self.in_features = kernel_q.shape[1]
        self.out_features = kernel_q.shape[0]
        self.register_buffer('kernel_q', kernel_q)
        self.register_buffer('scale', scale.float())
        self.bias = (None if bias is None
                     else nn.Parameter(bias.detach().clone(),
                                       requires_grad=False))
        if mode == 'w8a8':
            self.register_buffer('dyn', torch.zeros(0, dtype=torch.int8,
                                                    device=kernel_q.device))

    def _apply(self, fn, recurse=True):
        # a dtype change casts floating buffers: keep the scale in fp32 and
        # let it follow the kernel (int8, which only a move changes)
        scale = self.scale
        super()._apply(fn, recurse)
        self.scale = scale.to(self.kernel_q.device)
        return self

    def forward(self, x):
        return linear_q(x, self.kernel_q, self.scale, self.bias,
                        mode=self.mode)

    def extra_repr(self):
        return (f'in_features={self.in_features}, out_features='
                f'{self.out_features}, bias={self.bias is not None}, '
                f'mode={self.mode}')


def quantize_linear(linear, mode='w8a8'):
    """A ``nn.Linear`` -> the ``QLinear`` of its weights (the module is not
    changed; ``quantize_tree`` swaps it in).  A carved one (tensor
    parallelism) gives its slice of the whole layer's
    (``parallel.mesh.quantize_carved``)."""
    _check_mode(mode)
    if '_pm_carve' in linear.__dict__:
        from ..parallel.mesh import quantize_carved
        return quantize_carved(linear, mode)
    wq, scale = quantize_weight(linear.weight.detach())
    return QLinear(wq, scale, linear.bias, mode=mode)


def dequantize_linear(qlinear):
    """The inverse up to rounding: a ``QLinear`` -> an fp32 ``Linear``."""
    from .core import Linear
    out = Linear(qlinear.in_features, qlinear.out_features,
                 bias=qlinear.bias is not None,
                 device=qlinear.kernel_q.device)
    with torch.no_grad():
        out.weight.copy_(qlinear.kernel_q.float() * qlinear.scale[:, None])
        if qlinear.bias is not None:
            out.bias.copy_(qlinear.bias)
    return out


def is_quantized(module) -> bool:
    return isinstance(module, QLinear)


def quantize_tree(module, mode='w8a8', *, min_dim=64, predicate=None):
    """Swap, in place, every ``nn.Linear`` below ``module`` whose in and out
    features (of the whole layer, where it is carved) are both >=
    ``min_dim`` (and for which ``predicate(path, linear)`` holds, when
    given) for its ``QLinear``; returns ``module``.
    ``path`` is the tuple of module names from ``module`` down, without
    the layer indices of a ``nn.ModuleList``: the JAX package's path in its
    depth-stacked tree, e.g. ``('attn1', 'to_q')``."""
    from ..parallel.mesh import whole_features
    _check_mode(mode)

    def walk(parent, path):
        for name, child in parent.named_children():
            sub = path if name.isdigit() else path + (name,)
            if isinstance(child, nn.Linear):
                if (min(whole_features(child)) >= min_dim
                        and (predicate is None or predicate(sub, child))):
                    setattr(parent, name, quantize_linear(child, mode))
            else:
                walk(child, sub)

    walk(module, ())
    return module
