"""Flash-attention forward (kernel K1) and its plain PyTorch version.

Replaces ``paintmind_tpu/ops/flash_attention.py::_flash_forward`` (Pallas
kernel ``_attn_kernel``): non-causal ``softmax(q·kᵀ·scale)·v`` for self- and
cross-attention, in the JAX layout (B, N, H, D) x (B, M, H, D).

What bounds it on an H100: the 4·B·H·N·M·D multiply-adds (34 GFLOP for one
stage-2 self-attention at B = 8), not the bytes (q, k, v and o are 67 MB in
bf16).  The kernel (``csrc/flash_attention.cu``) keeps the (N, M) scores out
of device memory: each block owns 128 queries of one (batch, head) and
streams K/V tiles through shared memory with an online softmax in fp32, so
the only device-memory traffic is reading the operands and writing o.  This
first version runs the products on the fp32 CUDA cores; tensor cores
(``wgmma``) are later work (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
_fn = None


def flash_attention_plain(q, k, v, scale):
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D); fp32 logits and softmax,
    probabilities cast to the input type before the second product (the
    JAX package's ``_xla_attention``)."""
    logits = torch.einsum('bnhd,bmhd->bhnm', (q * scale).float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhnm,bmhd->bnhd', probs, v)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load('flash_attention').flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, scale):
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention: unsupported device {q.device}')
    b, n, h, d = q.shape
    m = k.shape[1]
    if d != HEAD_DIM:
        raise ValueError(f'flash_attention kernel takes head dim {HEAD_DIM}, '
                         f'got {d}')
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'flash_attention kernel takes fp32 or bf16 operands '
                        f'of one type, got {q.dtype}, {k.dtype}, {v.dtype}')
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f'flash_attention: shapes q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('flash_attention kernel takes contiguous operands')
    if not (k.device == q.device and v.device == q.device):
        raise ValueError('flash_attention: operands on different devices')
    global launches
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, n, m, h, d, float(scale),
                        _DTYPES[q.dtype], stream)
    _build.check(err, 'flash_attention')
    launches += 1
    return out
