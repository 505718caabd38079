"""Flash attention: forward (kernel K1), backward (kernel K4) and their plain
PyTorch versions.

Replaces ``paintmind_tpu/ops/flash_attention.py``: ``_flash_forward`` (Pallas
kernel ``_attn_kernel``) and ``_flash_backward`` (``_bwd_kernel``), wired
there as a ``custom_vjp`` and here as a ``torch.autograd.Function``.
Non-causal ``softmax(q·kᵀ·scale)·v`` for self- and cross-attention, in the
JAX layout (B, N, H, D) x (B, M, H, D).  The forward also takes
grouped-query attention, k and v with ``Hkv`` heads of which each serves
``H / Hkv`` query heads in turn (query head h reads KV head
``h // (H / Hkv)``: K and V are not repeated), and k and v as views whose
batch and row strides are their own (their last two axes contiguous), so
that it reads a preallocated KV cache's first M rows in place
(``nn/attention.py``'s cache path).  The backward takes neither: a
gradient through grouped or strided K/V raises.  The kernels are compiled for head
dims 64 and 128 (``HEAD_DIMS``); the wrappers zero-pad any head dim up to
128 to the next of them and slice the padding off the results, which is
exact: zero columns add nothing to q·kᵀ, and the padded columns of o, dq,
dk and dv are zero.  Head dims above 128 are not the kernels' (the JAX
package's 'auto' sends them to XLA, ``nn/attention.attention_core`` to the
plain version).

What bounds them on an H100: operations, not bytes.  The forward does
4·B·H·N·M·D, the backward's five products 10·B·H·N·M·D, and both keep the
(N, M) scores out of device memory.  The forward (``csrc/flash_attention.cu``)
gives each block a tile of queries of one (batch, head) and streams K/V tiles
through shared memory with an online softmax in fp32.  The backward
(``csrc/flash_attention_bwd.cu``) cannot carry dk/dv from one query block to
the next as the TPU grid does, so it splits the work by ownership into two
kernels (query blocks write dq, key blocks write dk and dv) and rebuilds P
in both from the forward's per-row log-sum-exp: no atomics, so the gradients
are the same bits on every run.

bf16 operands run every product on the tensor cores: ``wgmma`` (one
warpgroup of four warps owns 64 rows) reads swizzled bf16 tiles in shared
memory, which ``cp.async`` streams through a two-stage ring
(``csrc/attention_mma.cuh``); the scores, P and dS stay in registers, and P
and dS are rounded to bf16 there before the products that consume them, as
the TPU kernels round them.  fp32 operands keep kernels on the fp32 CUDA
cores, because their gates (1e-4 max abs forward, 1e-5 mean relative
backward) cannot take TF32.  The C entry points choose by type.  Still to
come on the way to the bound: TMA loads by a producer warp, and softmax
overlapped with the products inside a block (ROADMAP).

Residuals.  The JAX package keeps (q, k, v) and recomputes each row's max
and sum in the backward, which holds all M keys of a row at once.  The port
keeps (q, k, v, lse): the added memory is the (B, H, N) fp32 log-sum-exp,
4·B·H·N bytes per attention.  δ is summed inside K4 from P and dP, not taken
from the rounded output as rowsum(g∘o): see the note in
``csrc/flash_attention_bwd.cu``.

Beside each kernel stand its plain version (the arithmetic, on whole
matrices) and a tiled emulation of the bf16 kernel in plain PyTorch (the
same 64-key tiles, masking, zero padding, base-2 exponent and rounding
places): the emulations are called by the tests and ``chip_smoke.py`` only.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..utils import profiling
from . import _build

launches = 0      # K1 launches so far; chip_smoke.py resets and reads it
launches_bwd = 0  # K4 launches so far (one per backward call: its two kernels)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)  # the kernels' compiled head dims
_fns = {}


def kernel_head_dim(d):
    """The compiled head dim that a head dim ``d`` is zero-padded to."""
    for c in HEAD_DIMS:
        if d <= c:
            return c
    raise ValueError(f'flash_attention kernel takes head dims up to '
                     f'{HEAD_DIMS[-1]}, got {d}')


def _pad_head(t, d):
    """``t`` with zero columns up to head dim ``d`` (``t`` itself when it
    has them already): what the wrappers hand the kernels."""
    pad = d - t.shape[-1]
    return t if pad == 0 else torch.nn.functional.pad(t, (0, pad))


def _acc_dtype(t):
    """Accumulation type: fp32, or fp64 for fp64 operands (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _repeat_kv(q, k, v):
    """k and v with each of their Hkv heads repeated for the H / Hkv query
    heads that read it (``repeat_interleave``: query head h reads KV head
    h // (H / Hkv)); themselves when the head counts agree."""
    h, hkv = q.shape[2], k.shape[2]
    if h == hkv:
        return k, v
    if h % hkv:
        raise ValueError(f'flash_attention: {h} query heads over {hkv} KV '
                         'heads')
    return (k.repeat_interleave(h // hkv, dim=2),
            v.repeat_interleave(h // hkv, dim=2))


def flash_attention_plain(q, k, v, scale):
    """(B, N, H, D) x (B, M, Hkv, D) -> (B, N, H, D); fp32 logits and
    softmax, probabilities cast to the input type before the second product
    (the JAX package's ``_xla_attention``); Hkv < H groups the query heads
    (``_repeat_kv``)."""
    k, v = _repeat_kv(q, k, v)
    acc = _acc_dtype(q)
    logits = torch.einsum('bnhd,bmhd->bhnm', (q * scale).to(acc), k.to(acc))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhnm,bmhd->bnhd', probs, v)


def _rounded(t, dtype):
    """``t`` rounded to ``dtype`` and raised again: what a tensor-core
    product sees of an fp32 operand.  The identity for fp32 and fp64."""
    return t.to(dtype).to(t.dtype)


def flash_attention_backward_plain(q, k, v, g, scale):
    """(dq, dk, dv) of ``softmax(q·kᵀ·scale)·v`` for the cotangent ``g`` of
    the output, written out from the formulas (no autograd):

        P = softmax(q·kᵀ·scale)      dv = Pᵀ·g
        dP = g·vᵀ                    δ = rowsum(P∘dP)
        dS = P∘(dP − δ)·scale        dq = dS·k,  dk = dSᵀ·q

    Follows kernel K4 (and the TPU kernel): operands are raised to fp32, δ
    and dS are formed in fp32, then P (for dv) and dS (for dq, dk) are
    rounded to the operands' type before the products that consume them;
    the products accumulate in fp32 and each gradient is rounded once, to
    its operand's type.  fp32 and fp64 operands are rounded nowhere."""
    acc = _acc_dtype(q)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum('bnhd,bmhd->bhnm', qf, kf) * scale, dim=-1)
    dp = torch.einsum('bnhd,bmhd->bhnm', gf, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = _rounded(p * (dp - delta) * scale, q.dtype)
    dv = torch.einsum('bhnm,bnhd->bmhd', _rounded(p, q.dtype), gf)
    dq = torch.einsum('bhnm,bmhd->bnhd', ds, kf)
    dk = torch.einsum('bhnm,bnhd->bmhd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- tiled emulations of the bf16 kernels (tests and chip_smoke.py only) ---

TILE = 64  # rows of a shared-memory tile in the bf16 kernels
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _pad_tiles(t, dim=1):
    """Zero rows up to a multiple of ``TILE`` along ``dim``: what the
    kernels' zero-filling copies put past a ragged edge."""
    pad = -t.shape[dim] % TILE
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def flash_attention_tiled(q, k, v, scale):
    """The bf16 K1 step by step in plain PyTorch -> (o, lse): 64-key tiles
    with zero rows past M whose scores are set to −inf, zero query rows
    past N, a base-2 online softmax (running max, rescale, running sum from
    the unrounded p), P rounded to the operand type before P·V, the output
    scaled by 1/l, and lse = max·ln 2 + log l (natural log, (B, H, N)).
    Grouped K/V are read as the kernel reads them, query head h from KV head
    h // (H / Hkv)."""
    k, v = _repeat_kv(q, k, v)
    acc = _acc_dtype(q)
    n, m, d_in = q.shape[1], k.shape[1], q.shape[-1]
    dh = kernel_head_dim(d_in)
    qf, kf, vf = (_pad_tiles(_pad_head(t.to(acc), dh)) for t in (q, k, v))
    b, n_pad, h, d = qf.shape
    cols = torch.arange(TILE, device=q.device)
    o = qf.new_zeros(b, h, n_pad, d)
    m_run = qf.new_full((b, h, n_pad, 1), float('-inf'))
    l_run = qf.new_zeros(b, h, n_pad, 1)
    for k0 in range(0, m, TILE):
        ks, vs = kf[:, k0:k0 + TILE], vf[:, k0:k0 + TILE]
        s = torch.einsum('bnhd,bmhd->bhnm', qf, ks) * (scale * _LOG2E)
        s = s.masked_fill(k0 + cols >= m, float('-inf'))
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m_run - m_new)  # 0 on the first tile
        p = torch.exp2(s - m_new)
        l_run = l_run * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum('bhnm,bmhd->bhnd', _rounded(p, q.dtype), vs)
        m_run = m_new
    out = (o * (1.0 / l_run)).permute(0, 2, 1, 3)[:, :n, :, :d_in].to(q.dtype)
    lse = (m_run * _LN2 + torch.log(l_run))[:, :, :n, 0].float()
    return out.contiguous(), lse.contiguous()


def flash_attention_backward_tiled(q, k, v, g, scale, lse):
    """The bf16 K4 step by step in plain PyTorch -> (dq, dk, dv): the same
    tiles and zero padding (rows past N also get lse = 0, so their P is 1
    and their dP, dS are 0), P = 2^(s·scale·log2 e − lse·log2 e) with the
    columns past M set to 0, a first pass over the key tiles that sums
    δ = rowsum(P∘dP) in fp32, a second that forms dS in fp32 from the same
    P and dP, and P and dS rounded to the operand type before dv = Pᵀ·g,
    dq = dS·k and dk = dSᵀ·q.  (The dk/dv kernel sums over query tiles in
    order; here the whole padded query range is one product.)  Head dims
    are zero-padded to the compiled one, as by the wrapper."""
    acc = _acc_dtype(q)
    n, m, d_in = q.shape[1], k.shape[1], q.shape[-1]
    dh = kernel_head_dim(d_in)
    qf, kf, vf, gf = (_pad_tiles(_pad_head(t.to(acc), dh))
                      for t in (q, k, v, g))
    lse2 = _pad_tiles(lse.to(acc), dim=2)[..., None] * _LOG2E
    cols = torch.arange(TILE, device=q.device)

    def p_and_dp(k0):
        s = torch.einsum('bnhd,bmhd->bhnm', qf, kf[:, k0:k0 + TILE])
        p = torch.exp2(s * (scale * _LOG2E) - lse2)
        p = p.masked_fill(k0 + cols >= m, 0.0)
        return p, torch.einsum('bnhd,bmhd->bhnm', gf, vf[:, k0:k0 + TILE])

    delta = 0.0
    for k0 in range(0, m, TILE):
        p, dp = p_and_dp(k0)
        delta = delta + (p * dp).sum(dim=-1, keepdim=True)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for k0 in range(0, m, TILE):
        p, dp = p_and_dp(k0)
        ds = _rounded(p * (dp - delta) * scale, q.dtype)
        dq += torch.einsum('bhnm,bmhd->bnhd', ds, kf[:, k0:k0 + TILE])
        dk[:, k0:k0 + TILE] = torch.einsum('bhnm,bnhd->bmhd', ds, qf)
        dv[:, k0:k0 + TILE] = torch.einsum('bhnm,bnhd->bmhd',
                                           _rounded(p, q.dtype), gf)
    return (dq[:, :n, :, :d_in].to(q.dtype), dk[:, :m, :, :d_in].to(k.dtype),
            dv[:, :m, :, :d_in].to(v.dtype))


def _kernel(name):
    if name not in _fns:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if name == 'fwd':
            fn = _build.load('flash_attention').flash_attention_fwd
            i64 = ctypes.c_longlong
            fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 4
                           + [ctypes.c_float, i32, ptr])
        else:
            fn = _build.load('flash_attention_bwd').flash_attention_bwd
            fn.argtypes = [ptr] * 9 + [i32] * 5 + [ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_operands(q, k, v, scale, strided=False):
    """Raise on what the kernels do not take.  ``strided`` (the forward):
    k and v may have fewer heads than q, dividing them, and batch and row
    strides of their own."""
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention: unsupported device {q.device}')
    if not scale > 0:
        raise ValueError(f'flash_attention kernel takes a positive scale, '
                         f'got {scale}')
    b, n, h, d = q.shape
    m = k.shape[1]
    kernel_head_dim(d)  # raises above the largest compiled head dim
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'flash_attention kernel takes fp32 or bf16 operands '
                        f'of one type, got {q.dtype}, {k.dtype}, {v.dtype}')
    hkv = k.shape[2] if strided and k.ndim == 4 else h
    if (k.shape != (b, m, hkv, d) or v.shape != k.shape or h % hkv):
        raise ValueError(f'flash_attention: shapes q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if not (q.is_contiguous() and (strided or (k.is_contiguous()
                                               and v.is_contiguous()))):
        raise ValueError('flash_attention kernel takes contiguous operands')
    if strided and any(t.stride(3) != 1 or t.stride(2) != d
                       or t.stride(0) % 8 or t.stride(1) % 8 for t in (k, v)):
        raise ValueError(f'flash_attention kernel takes k and v whose heads '
                         f'and dims are contiguous and whose batch and row '
                         f'strides are multiples of 8 elements: k '
                         f'{k.stride()}, v {v.stride()}')
    if not (k.device == q.device and v.device == q.device):
        raise ValueError('flash_attention: operands on different devices')
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError('flash_attention kernel takes operands aligned to '
                         '16 bytes')


def _launch_forward(q, k, v, scale, with_lse):
    """K1 on CUDA operands -> (o, lse or None); head dims below a compiled
    one are zero-padded to it (see the module's docstring); k and v may be
    grouped and strided (``_check_operands``)."""
    _check_operands(q, k, v, scale, strided=True)
    b, n, h, d_in = q.shape
    d = kernel_head_dim(d_in)
    q, k, v = (_pad_head(t, d) for t in (q, k, v))
    global launches
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, n, device=q.device, dtype=torch.float32)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, n, k.shape[1], h,
            k.shape[2], d, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale), _DTYPES[q.dtype], stream)
    if torch.cuda.current_device() == q.device.index:
        err = _kernel('fwd')(*args)
    else:
        with torch.cuda.device(q.device):
            err = _kernel('fwd')(*args)
    _build.check(err, 'flash_attention')
    launches += 1
    return (out if d == d_in else out[..., :d_in].contiguous()), lse


def flash_attention_backward(q, k, v, g, scale, lse=None):
    """K4 on CUDA tensors, the plain version on CPU tensors: (dq, dk, dv).
    ``lse`` is the forward's (B, H, N) fp32 log-sum-exp, which the kernel
    needs (the plain version does not).  ``g`` is made contiguous."""
    if q.device.type == 'cpu':
        return flash_attention_backward_plain(q, k, v, g, scale)
    _check_operands(q, k, v, scale)
    b, n, h, d_in = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f'flash_attention backward: cotangent '
                         f'{tuple(g.shape)} {g.dtype} on {g.device} does not '
                         f'match the output {tuple(q.shape)} {q.dtype} on '
                         f'{q.device}')
    if (lse is None or lse.shape != (b, h, n) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention backward: lse is not the forward's "
                         '(B, H, N) fp32 log-sum-exp')
    d = kernel_head_dim(d_in)
    q, k, v, g = (_pad_head(t, d) for t in (q, k, v, g.contiguous()))
    if g.data_ptr() % 16:
        g = g.clone()  # a fresh allocation is aligned
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
    if d != d_in:
        dq, dk, dv = (t[..., :d_in].contiguous() for t in (dq, dk, dv))
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


def attention_cost(q, k):
    """(operations, K and V bytes) of one call: 4·B·H·N·M·D, and K and V
    read once, each KV head once."""
    b, n, h, d = q.shape
    m, hkv = k.shape[1], k.shape[2]
    return 4 * b * h * n * m * d, 2 * b * m * hkv * d * k.element_size()


def flash_attention(q, k, v, scale):
    """K1 on a CUDA tensor, the plain version on a CPU tensor.  When a
    gradient can flow (grad mode on and an operand requires it) the call goes
    through the ``autograd.Function``, so the result carries a ``grad_fn``
    whose backward is K4; otherwise it is the bare forward, which also takes
    grouped and strided K/V (the module's docstring).  While the port's
    counters record (or a graph's capture tallies them), each call adds its
    operations and K/V bytes to ``pm.attn.ops`` and ``pm.attn.kv_bytes``."""
    if profiling.counting():
        ops, kv_bytes = attention_cost(q, k)
        profiling.count('pm.attn.ops', ops)
        profiling.count('pm.attn.kv_bytes', kv_bytes)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if k.shape[2] != q.shape[2] or not (k.is_contiguous()
                                            and v.is_contiguous()):
            raise NotImplementedError(
                'flash_attention: no backward through grouped-query or '
                'strided K/V (kernel K4 takes contiguous K/V with the '
                "queries' heads)")
        return _FlashAttention.apply(q, k, v, scale)
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, scale)
    return _launch_forward(q, k, v, scale, with_lse=False)[0]
