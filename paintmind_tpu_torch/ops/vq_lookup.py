"""Fused codebook nearest-neighbour lookup (kernel K2) and its plain version.

Replaces ``paintmind_tpu/ops/vq_lookup.py::_fused_nearest_codes`` (Pallas
kernel ``_lookup_kernel``): for l2-normalised queries z (T, 32) and codebook
rows e (C, 32), ``argmax_j z·e_j`` with ties to the lowest index.

What bounds it on an H100: the 2·T·C·32 fp32 operations (4.3 GFLOP at
T = 8·1024, C = 8192); the operands are only ~2 MB.  The kernel
(``csrc/vq_lookup.cu``) never writes the (T, C) score matrix (268 MB at that
size) to device memory: each block keeps a running (best value, best index)
per token while it streams the codebook through shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

CODE_DIM = 32
_fn = None


def nearest_codes_plain(z_norm, codebook_norm):
    """z_norm: (..., D); codebook_norm: (C, D) -> int32 (...,)."""
    sim = z_norm.float() @ codebook_norm.float().t()
    return torch.argmax(sim, dim=-1).to(torch.int32)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load('vq_lookup').vq_lookup_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_nearest_codes(z_norm, codebook_norm):
    """K2 on a CUDA tensor, the plain version on a CPU tensor.  z_norm:
    (..., 32) fp32, codebook_norm: (C, 32) fp32 -> int32 (...,)."""
    if z_norm.device.type == 'cpu':
        return nearest_codes_plain(z_norm, codebook_norm)
    if z_norm.device.type != 'cuda' or codebook_norm.device != z_norm.device:
        raise ValueError(f'fused_nearest_codes: devices {z_norm.device}, '
                         f'{codebook_norm.device}')
    if z_norm.dtype != torch.float32 or codebook_norm.dtype != torch.float32:
        raise TypeError('fused_nearest_codes kernel takes fp32 operands, got '
                        f'{z_norm.dtype}, {codebook_norm.dtype}')
    if z_norm.shape[-1] != CODE_DIM or codebook_norm.ndim != 2 or \
            codebook_norm.shape[1] != CODE_DIM:
        raise ValueError(f'fused_nearest_codes kernel takes code dim '
                         f'{CODE_DIM}: z {tuple(z_norm.shape)}, '
                         f'codebook {tuple(codebook_norm.shape)}')
    if not (z_norm.is_contiguous() and codebook_norm.is_contiguous()):
        raise ValueError('fused_nearest_codes kernel takes contiguous operands')
    if z_norm.data_ptr() % 16 or codebook_norm.data_ptr() % 16:
        raise ValueError('fused_nearest_codes kernel takes 16-byte aligned '
                         'operands')
    shape = z_norm.shape[:-1]
    t = z_norm.numel() // CODE_DIM
    out = torch.empty(shape, dtype=torch.int32, device=z_norm.device)
    if t == 0:
        return out
    global launches
    stream = torch.cuda.current_stream(z_norm.device).cuda_stream
    with torch.cuda.device(z_norm.device):
        err = _kernel()(z_norm.data_ptr(), codebook_norm.data_ptr(),
                        out.data_ptr(), t, codebook_norm.shape[0], CODE_DIM,
                        stream)
    _build.check(err, 'vq_lookup')
    launches += 1
    return out
