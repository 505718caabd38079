"""Fused MaskGIT sampling head (kernel K3, Triton) and its plain version.

Replaces ``paintmind_tpu/ops/sampling.py::_fused_gumbel_topk_sample``
(Pallas kernel ``_sample_kernel``).  One pass over each logits row produces

  * ``pred``: the Gumbel-max sample over the exact top-k filtered,
    temperature-scaled logits (``topk_keep_mask``: exactly k candidates,
    ties to the lower index, even with duplicated bf16 values);
  * ``conf``: softmax(original logits)[pred], the re-mask confidence.

What bounds it on an H100: the bytes.  The logits are read once (268 MB in
fp32, 134 MB in bf16, at B = 8 · 1024 tokens · 8192 codes) and the work per
element is a few dozen operations, far below the card's operations-per-byte
balance.  The kernel therefore keeps each row in registers (one program per
row, the whole 8192-wide row at once) and does the logsumexp, the k iterated
maxima, the noise and the argmax there; nothing but (pred, conf) is written.

Randomness: Triton's Philox stream (``tl.rand``) keyed by a per-call seed
drawn from the caller's ``torch.Generator``, at counter row·V + column, so
two calls never share a stream unless their seeds are equal.  It is not
the TPU's stream, nor ``jax.random``'s: the kernel is held against its plain
version at temperature ~0 (deterministic) and against the top-k softmax
distribution at temperature 1.
"""

from __future__ import annotations

import torch

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

NEG_INF = -1e30
_kernel_fn = None


def topk_keep_mask(l, k):
    """Boolean (..., V) mask keeping exactly the k largest entries per row,
    ties broken toward the lower index (the order of a stable descending
    sort).  Same two-phase integer-exact algorithm as the JAX package:
    k-th order statistic by iterated distinct maxima that stop once the
    ``>=`` count reaches k, then the lowest indices among entries equal to
    that threshold."""
    thr = l.amax(dim=-1, keepdim=True)
    cnt = (l >= thr).sum(dim=-1, keepdim=True)
    neg = torch.full((), NEG_INF, dtype=l.dtype, device=l.device)
    for _ in range(k - 1):
        nxt = torch.where(l < thr, l, neg).amax(dim=-1, keepdim=True)
        thr = torch.where(cnt < k, nxt, thr)
        cnt = (l >= thr).sum(dim=-1, keepdim=True)
    gt = l > thr
    need = k - gt.sum(dim=-1, keepdim=True)
    eq = l == thr
    big = torch.full((), 2 ** 30, dtype=torch.int64, device=l.device)
    col = torch.arange(l.shape[-1], device=l.device).expand(l.shape)
    idx = torch.where(eq, col, big)
    cut = idx.amin(dim=-1, keepdim=True)
    for i in range(1, k):
        nxt = torch.where(idx > cut, idx, big).amin(dim=-1, keepdim=True)
        cut = torch.where(i < need, nxt, cut)
    return gt | (eq & (col <= cut))


def gumbel_noise(shape, *, generator=None, device=None):
    """-log(-log(u)), u uniform in [0, 1) clipped at 1e-20 (reference
    gumbel_noise, generate.py:40-42)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=1e-20)))


def _row_temperatures(temperature, shape, device):
    """Scalar or per-sample (B,) temperature -> fp32 (T,) per row of the
    flattened (..., V) logits."""
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=device)
    if temp.ndim == 0:
        return temp.expand(shape).reshape(-1)
    return temp.reshape(-1, *([1] * (len(shape) - 1))).expand(shape).reshape(-1)


def gumbel_topk_sample_plain(logits, temperature, k, noise):
    """The kernel's arithmetic in PyTorch ops.  logits (..., V); temperature
    scalar or (B,); noise (..., V) Gumbel noise.  Returns (pred int32,
    conf fp32), each of shape logits.shape[:-1]."""
    shape = logits.shape[:-1]
    l = logits.float()
    row_max = l.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(l - row_max).sum(dim=-1, keepdim=True))
    keep = topk_keep_mask(l, k)
    temp = torch.clamp(_row_temperatures(temperature, shape, l.device),
                       min=1e-10).reshape(*shape, 1)
    masked = torch.where(keep, l / temp + noise.float(),
                         torch.full((), NEG_INF, device=l.device))
    pred = torch.argmax(masked, dim=-1, keepdim=True)
    picked = torch.gather(l, -1, pred)
    conf = torch.exp(picked - row_max - lse)
    return pred[..., 0].to(torch.int32), conf[..., 0]


def _kernel():
    """Builds the Triton kernel at its first launch (the CPU sandbox that
    runs the tests has no triton)."""
    global _kernel_fn
    if _kernel_fn is not None:
        return _kernel_fn
    import triton
    import triton.language as tl

    @triton.jit
    def sample_kernel(logits_ptr, temp_ptr, seed_ptr, pred_ptr, conf_ptr, V,
                      stride, K: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        col = tl.arange(0, BLOCK)
        valid = col < V
        l = tl.load(logits_ptr + row.to(tl.int64) * stride + col, mask=valid,
                    other=float('-inf')).to(tl.float32)

        row_max = tl.max(l, axis=0)
        lse = tl.log(tl.sum(tl.exp(l - row_max), axis=0))

        # exact top-k, ties to the lower index (topk_keep_mask)
        thr = row_max
        cnt = tl.sum((l >= thr).to(tl.int32), axis=0)
        for _ in tl.static_range(K - 1):
            nxt = tl.max(tl.where(l < thr, l, -1e30), axis=0)
            thr = tl.where(cnt < K, nxt, thr)
            cnt = tl.sum((l >= thr).to(tl.int32), axis=0)
        gt = l > thr
        need = K - tl.sum(gt.to(tl.int32), axis=0)
        eq = l == thr
        idx = tl.where(eq, col, 1073741824)
        cut = tl.min(idx, axis=0)
        for i in tl.static_range(1, K):
            nxt_i = tl.min(tl.where(idx > cut, idx, 1073741824), axis=0)
            cut = tl.where(i < need, nxt_i, cut)
        keep = gt | (eq & (col <= cut))

        seed = tl.load(seed_ptr)
        u = tl.rand(seed, row * V + col)
        g = -tl.log(-tl.log(tl.maximum(u, 1e-20)))
        temp = tl.maximum(tl.load(temp_ptr + row), 1e-10)
        masked = tl.where(keep, l / temp + g, -1e30)
        pred = tl.argmax(masked, axis=0)

        picked = tl.max(tl.where(col == pred, l, -1e30), axis=0)
        conf = tl.exp(picked - row_max - lse)
        tl.store(pred_ptr + row, pred.to(tl.int32))
        tl.store(conf_ptr + row, conf)

    _kernel_fn = sample_kernel
    return _kernel_fn


def fused_gumbel_topk_sample(logits, temperature, k=5, *, generator=None):
    """K3 on a CUDA tensor, the plain version (with noise drawn from
    ``generator``) on a CPU tensor.  logits: (..., V) fp32 or bf16;
    temperature: scalar or per-sample (B,) (B = logits.shape[0]).  Returns
    (pred int32 (...,), conf fp32 (...,))."""
    if logits.device.type == 'cpu':
        noise = gumbel_noise(logits.shape, generator=generator,
                             device=logits.device)
        return gumbel_topk_sample_plain(logits, temperature, k, noise)
    if logits.device.type != 'cuda':
        raise ValueError(f'fused_gumbel_topk_sample: device {logits.device}')
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'fused_gumbel_topk_sample takes fp32 or bf16 logits, '
                        f'got {logits.dtype}')
    if not logits.is_contiguous():
        raise ValueError('fused_gumbel_topk_sample takes contiguous logits')
    shape = logits.shape[:-1]
    v = logits.shape[-1]
    if not 1 <= k <= v:
        raise ValueError(f'top-k {k} out of range for {v} classes')
    t = logits.numel() // v
    if t * v >= 2 ** 31:
        raise ValueError(f'{t} x {v} logits: the Philox counter would overflow')
    temps = _row_temperatures(temperature, shape, logits.device).contiguous()
    seed = torch.randint(0, 2 ** 30, (1,), generator=generator,
                         device=logits.device, dtype=torch.int32)
    pred = torch.empty(shape, dtype=torch.int32, device=logits.device)
    conf = torch.empty(shape, dtype=torch.float32, device=logits.device)
    if t == 0:
        return pred, conf
    global launches
    with torch.cuda.device(logits.device):
        _kernel()[(t,)](logits, temps, seed, pred, conf, v, v, K=k,
                        BLOCK=1 << (v - 1).bit_length(), num_warps=8)
    launches += 1
    return pred, conf
