"""Flash attention: forward (kernel K1), backward (kernel K4) and their plain
PyTorch versions.

Replaces ``paintmind_tpu/ops/flash_attention.py``: ``_flash_forward`` (Pallas
kernel ``_attn_kernel``) and ``_flash_backward`` (``_bwd_kernel``), wired
there as a ``custom_vjp`` and here as a ``torch.autograd.Function``.
Non-causal ``softmax(q·kᵀ·scale)·v`` for self- and cross-attention, in the
JAX layout (B, N, H, D) x (B, M, H, D).

What bounds them on an H100: operations, not bytes.  The forward does
4·B·H·N·M·D (34 GFLOP for one stage-2 self-attention at B = 8; q, k, v and o
are 67 MB in bf16), the backward's five products 10·B·H·N·M·D.  Both kernels
keep the (N, M) scores out of device memory.  The forward
(``csrc/flash_attention.cu``) gives each block 128 queries of one (batch,
head) and streams K/V tiles through shared memory with an online softmax in
fp32.  The backward (``csrc/flash_attention_bwd.cu``) cannot carry dk/dv
from one query block to the next as the TPU grid does, so it splits the work
by ownership into two kernels (query blocks write dq, key blocks write dk
and dv) and rebuilds P in both from the forward's per-row log-sum-exp: no
atomics, so the gradients are the same bits on every run.  These first
versions run their products on the fp32 CUDA cores; tensor cores
(``wgmma``) are later work (ROADMAP).

Residuals.  The JAX package keeps (q, k, v) and recomputes each row's max
and sum in the backward, which holds all M keys of a row at once.  The port
keeps (q, k, v, lse): the added memory is the (B, H, N) fp32 log-sum-exp,
0.5 MB per attention at B = 8, H = 16, N = 1024.  δ is summed inside K4 from
P and dP, not taken from the rounded output as rowsum(g∘o): see the note in
``csrc/flash_attention_bwd.cu``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build

launches = 0      # K1 launches so far; chip_smoke.py resets and reads it
launches_bwd = 0  # K4 launches so far (one per backward call: its two kernels)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
_fns = {}


def _acc_dtype(t):
    """Accumulation type: fp32, or fp64 for fp64 operands (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_plain(q, k, v, scale):
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D); fp32 logits and softmax,
    probabilities cast to the input type before the second product (the
    JAX package's ``_xla_attention``)."""
    acc = _acc_dtype(q)
    logits = torch.einsum('bnhd,bmhd->bhnm', (q * scale).to(acc), k.to(acc))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhnm,bmhd->bnhd', probs, v)


def flash_attention_backward_plain(q, k, v, g, scale):
    """(dq, dk, dv) of ``softmax(q·kᵀ·scale)·v`` for the cotangent ``g`` of
    the output, written out from the formulas (no autograd):

        P = softmax(q·kᵀ·scale)      dv = Pᵀ·g
        dP = g·vᵀ                    δ = rowsum(P∘dP)
        dS = P∘(dP − δ)·scale        dq = dS·k,  dk = dSᵀ·q

    Follows kernel K4: operands are raised to fp32, P and dS stay in fp32
    through their products (the TPU kernel rounds them to the input type
    first), and each gradient is rounded once, to its operand's type."""
    acc = _acc_dtype(q)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum('bnhd,bmhd->bhnm', qf, kf) * scale, dim=-1)
    dv = torch.einsum('bhnm,bnhd->bmhd', p, gf)
    dp = torch.einsum('bnhd,bmhd->bhnm', gf, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum('bhnm,bmhd->bnhd', ds, kf)
    dk = torch.einsum('bhnm,bnhd->bmhd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel(name):
    if name not in _fns:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if name == 'fwd':
            fn = _build.load('flash_attention').flash_attention_fwd
            fn.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_float, i32, ptr]
        else:
            fn = _build.load('flash_attention_bwd').flash_attention_bwd
            fn.argtypes = [ptr] * 9 + [i32] * 5 + [ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_operands(q, k, v):
    """Raise on what the kernels do not take."""
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


def _launch_forward(q, k, v, scale, with_lse):
    """K1 on CUDA operands -> (o, lse or None)."""
    _check_operands(q, k, v)
    b, n, h, d = q.shape
    global launches
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, n, device=q.device, dtype=torch.float32)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel('fwd')(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             None if lse is None else lse.data_ptr(),
                             b, n, k.shape[1], h, d, float(scale),
                             _DTYPES[q.dtype], stream)
    _build.check(err, 'flash_attention')
    launches += 1
    return out, lse


def flash_attention_backward(q, k, v, g, scale, lse=None):
    """K4 on CUDA tensors, the plain version on CPU tensors: (dq, dk, dv).
    ``lse`` is the forward's (B, H, N) fp32 log-sum-exp, which the kernel
    needs (the plain version does not).  ``g`` is made contiguous."""
    if q.device.type == 'cpu':
        return flash_attention_backward_plain(q, k, v, g, scale)
    _check_operands(q, k, v)
    b, n, h, d = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f'flash_attention backward: cotangent '
                         f'{tuple(g.shape)} {g.dtype} on {g.device} does not '
                         f'match the output {tuple(q.shape)} {q.dtype} on '
                         f'{q.device}')
    if (lse is None or lse.shape != (b, h, n) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention backward: lse is not the forward's "
                         '(B, H, N) fp32 log-sum-exp')
    g = g.contiguous()
    global launches_bwd
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    # the stream of the thread that runs the backward, read at launch time
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel('bwd')(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
                             n, k.shape[1], h, d, float(scale),
                             _DTYPES[q.dtype], stream)
    _build.check(err, 'flash_attention backward')
    launches_bwd += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K4 backward; on CPU tensors their plain versions, through
    the same wiring."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == 'cpu':
            ctx.save_for_backward(q, k, v)
            return flash_attention_plain(q, k, v, scale)
        out, lse = _launch_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, *lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, g, ctx.scale, *lse)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None)


def flash_attention(q, k, v, scale):
    """K1 on a CUDA tensor, the plain version on a CPU tensor.  When a
    gradient can flow (grad mode on and an operand requires it) the call goes
    through the ``autograd.Function``, so the result carries a ``grad_fn``
    whose backward is K4; otherwise it is the bare forward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, scale)
    return _launch_forward(q, k, v, scale, with_lse=False)[0]
