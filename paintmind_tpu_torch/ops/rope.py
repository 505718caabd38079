"""QK-norm and the rotary embedding of SDAR-30B-A3B's attention in one pass
(kernel K6, ``csrc/rope.cu``) and its plain version.

Replaces no TPU kernel (the JAX package has no SDAR stack).  ``norm_rope``
takes q or k (B, N, H, D), normalises each head's D dims by an RMSNorm
with gain ``weight`` (QK-norm, in fp32), rotates them by the rotary
tables of the tokens' positions (``nn.core.rope_tables``: ``x·cos +
rotate_half(x)·sin``, the sine's first half negated so that
``rotate_half(x)·sin`` is ``roll(x, D/2)·sin``) and rounds once to x's type.
On the card K6 does it for bf16 at D = 64 or 128 in one read and one write
(a warp a row), storing into ``out`` in place when one is given (the KV
cache's rows, a strided view); on the CPU the plain version.  What bounds
K6 and why it exists: the note in ``csrc/rope.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # K6 launches so far; chip_smoke.py reads it
_fns = {}
_sms = {}


def norm_rope_plain(x, cos, sin, weight, eps=1e-6):
    """The function on whole tensors, in fp32, rounded once to x's type:
    the gain folds into the tables (``rotate_half(x·w) = roll(x)·roll(w)
    ·sign``) and each row's ``1 / sqrt(mean(x²) + eps)`` scales the sum."""
    half = x.shape[-1] // 2
    w = weight.float()
    cos, sin = cos * w, sin * w.roll(half)
    out = torch.addcmul(x * cos[:, None], x.roll(half, dims=-1), sin[:, None])
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True, dtype=torch.float32)
    out.mul_(torch.rsqrt(n.square_().div_(x.shape[-1]).add_(eps)))
    return out.to(x.dtype)


def _kernel():
    if 'norm_rope' not in _fns:
        fn = _build.load('rope').norm_rope
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [ll] * 2 + [i] * 4 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fns['norm_rope'] = fn
    return _fns['norm_rope']


def norm_rope(x, cos, sin, weight, eps=1e-6, out=None):
    """x (B, N, H, D) normalised with the (D,) gain ``weight`` and rotated by the (N, D)
    fp32 tables; written into ``out`` (B, N, H, D) when given (its heads
    and dims contiguous, its batch and token strides its own), else into a
    new tensor.  Returns the result.  K6 for a bf16 tensor on the card, the
    plain version on the CPU; raises otherwise."""
    if x.device.type == 'cpu':
        y = norm_rope_plain(x, cos, sin, weight, eps)
        return y if out is None else out.copy_(y)
    b, n, h, d = x.shape
    if (x.device.type != 'cuda' or x.dtype != torch.bfloat16 or d not in (64, 128)
            or not x.is_contiguous()
            or any(t.dtype != torch.float32 or t.shape != (n, d)
                   or not t.is_contiguous() or t.device != x.device
                   for t in (cos, sin))
            or weight.dtype != x.dtype or weight.shape != (d,)
            or weight.device != x.device):
        raise ValueError(
            f'norm_rope kernel takes contiguous bf16 x (B, N, H, 64 or 128) on '
            f'the card, (N, D) fp32 tables and a bf16 (D,) weight: x '
            f'{x.dtype} {tuple(x.shape)} on {x.device}, tables '
            f'{cos.dtype} {tuple(cos.shape)}, weight '
            f'{weight.dtype} {tuple(weight.shape)}')
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
          or out.stride(3) != 1 or out.stride(2) != d or out.stride(0) % 8
          or out.stride(1) % 8):
        raise ValueError(f'norm_rope: out {out.dtype} {tuple(out.shape)} '
                         f'strides {out.stride()} for x {tuple(x.shape)}')
    dev = x.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    global launches
    args = (x.data_ptr(), weight.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), out.data_ptr(), out.stride(0),
            out.stride(1), b, n, h, d, float(eps), _sms[dev],
            torch.cuda.current_stream(dev).cuda_stream)
    if torch.cuda.current_device() == dev.index:
        err = _kernel()(*args)
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args)
    _build.check(err, 'norm_rope')
    launches += 1
    return out
