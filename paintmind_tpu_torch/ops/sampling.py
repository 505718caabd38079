"""Fused MaskGIT sampling head (kernel K3, CUDA C++) and its plain version.

Replaces ``paintmind_tpu/ops/sampling.py::_fused_gumbel_topk_sample``
(Pallas kernel ``_sample_kernel``).  One pass over each logits row produces

  * ``pred``: the Gumbel-max sample over the exact top-k filtered,
    temperature-scaled logits (``topk_keep_mask``: exactly k candidates,
    ties to the lower index, even with duplicated bf16 values);
  * ``conf``: softmax(original logits)[pred], the re-mask confidence.

What bounds it on an H100: the bytes.  The logits are read once (268 MB in
fp32, 134 MB in bf16, at B = 8 x 1024 tokens x 8192 codes) and the work a
logit cannot avoid is a max, an exp and a compare.  The TPU kernel's row
reductions (some nineteen of them) are each a barrier across a block here,
and its noise for every column is 8192 Philox evaluations where k are used.
The kernel (``csrc/sampling.cu``) therefore gives a row to one warp, which
streams it once in 16-byte loads: each lane keeps an online log-sum-exp and
a sorted list of its own k best (value, column) in registers (checked
against a bound on the row's k-th value that the lanes share now and then,
so that most chunks cost one compare), the lanes merge by shuffle
tournaments under the total order (value descending, column ascending),
which is exactly ``topk_keep_mask``, and the noise is drawn for the k
survivors alone.  There is no barrier and no shared memory.

Longer lists cost more than a radix select, so larger k (any k up to V)
goes to a second kernel in the same source (K3r): one block a row, a
radix select on order-preserving integer keys (16-bit for bf16, 32-bit for
fp32).  One read of the row counts the keys' top 11 bits and keeps the keys
in shared memory (rows longer than 8192 are read again from memory); one
sweep writes the keys at or above the chosen bin into a 1024-entry buffer
in column order; one warp then runs the later passes (bf16: 5 bits; fp32: 11
and 10), admits the keys tied at the threshold lowest column first and
draws the noise at the survivors, over the buffer, or over the row again
when it overflows (mass ties).  It is bound by the same bytes.  The wrapper
picks the kernel by k: the radix kernel above ``MAX_K`` = 5 (on an H100 it
took a quarter of the time of 16-entry lists at k = 6 and 16); each counts
its own launches.  ``sample_radix`` is that kernel's algorithm on the CPU.

Randomness: Philox 4x32-10 under a 64-bit per-call seed drawn from the
caller's ``torch.Generator``, at counter (column, row low, row high, 0), so
the noise of an entry depends on nothing but (seed, row, column).
``philox_uniform`` / ``philox_gumbel`` are the same generator in PyTorch
integer arithmetic: with them the kernel is held against its plain version
sample for sample.  It is not the TPU's stream, nor ``jax.random``'s.
``sample_streamed`` is the kernel's algorithm, lane for lane, on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# kernel launches so far (K3, K3r); chip_smoke.py resets and reads them
launches = 0
launches_radix = 0

NEG_INF = -1e30
MAX_K = 5                   # the kernel's longest per-lane list; the radix
                            # kernel takes every larger k
LIST_SIZES = (1, 5)         # list lengths the kernel is compiled for
UNROLL = 4                  # 16-byte chunks a lane has in flight (one group)
RADIX_FIRST_BITS = 11       # the radix kernel's first digit: the key's top bits
RADIX_LATER_BITS = 11       # the widest digit of a later pass
RADIX_CAP = 1024            # entries of its buffer
_fns = {}


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


def draw_seed(generator, device):
    """The kernel's per-call seed: one int64 below 2**62 drawn on ``device``
    from ``generator``, without a host synchronisation."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=device,
                         dtype=torch.int64)


_MASK32 = 0xFFFFFFFF


def _mulhilo(m, c):
    """(high, low) 32-bit words of the constant m times the int64 tensor c,
    both below 2**32, without leaving int64's range: c is cut in 16-bit
    halves, so no partial product passes 2**48."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    return (b + (a >> 16)) >> 16, (((b & 0xFFFF) << 16) + a) & _MASK32


def philox4x32(counter, key):
    """Philox 4x32-10 (Salmon et al. 2011): four counter words and two key
    words, int64 tensors below 2**32 -> the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_uniform(seed, rows, cols):
    """The kernel's uniforms in PyTorch integer arithmetic: Philox 4x32-10
    with key (seed low word, seed high word) at counter (column, row low
    word, row high word, 0); the first output word's top 24 bits times
    2**-24, so u lies in [0, 1).  seed: int or int64 tensor of one element;
    rows, cols: broadcastable integer tensors.  Returns fp32 of the
    broadcast shape."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    cols = torch.as_tensor(cols, dtype=torch.int64, device=rows.device)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=rows.device).reshape(())
    rows, cols = torch.broadcast_tensors(rows, cols)
    word = philox4x32(
        (cols & _MASK32, rows & _MASK32, (rows >> 32) & _MASK32,
         torch.zeros_like(cols)),
        (seed & _MASK32, (seed >> 32) & _MASK32))[0]
    return (word >> 8).to(torch.float32) * 2.0 ** -24


def philox_gumbel(seed, shape, *, device=None):
    """The Gumbel noise (..., V) the kernel would draw for logits of this
    shape under ``seed`` (rows are the flattened leading dimensions), had it
    drawn it for every column: -log(-log(max(u, 1e-20)))."""
    v = shape[-1]
    t = int(np.prod(shape[:-1], dtype=np.int64))
    rows = torch.arange(t, device=device).reshape(*shape[:-1], 1)
    u = philox_uniform(seed, rows, torch.arange(v, device=device))
    return -torch.log(-torch.log(torch.clamp(u, min=1e-20)))


_LOG2E = np.float32(1.4426950408889634)
_NO_COL = 0x7FFFFFFF


def _list_size(k):
    return next(n for n in LIST_SIZES if n >= k)


def _before(av, ac, bv, bc):
    """(value, column) a before b in the selection's total order."""
    return (av > bv) | ((av == bv) & (ac < bc))


def _stream_row(x, noise, temp, k, vec, head):
    """One row through the kernel's algorithm.  x, noise: (V,) fp32 numpy;
    head: elements before the row's first 16-byte boundary.  Returns (pred,
    conf, kept columns in order)."""
    v = x.shape[0]
    size = _list_size(k)
    lanes = np.arange(32)
    val = np.full((32, size), -np.inf, np.float32)
    col = np.full((32, size), _NO_COL, np.int64)
    m = np.full(32, -np.inf, np.float32)
    s = np.zeros(32, np.float32)
    thr = np.full(32, -np.inf, np.float32)  # max(val[:, -1], the warp's bound)

    def rescale(a, b):
        with np.errstate(invalid='ignore'):
            return np.where(a == b, np.float32(1),
                            np.exp2((a - b) * _LOG2E)).astype(np.float32)

    def consume(cols, active):
        """cols: (32, N) columns, one run per lane; active: lanes that have
        this chunk."""
        nonlocal m, s, thr
        xs = x[np.where(active[:, None], cols, 0)]
        nm = np.maximum(m, xs.max(1))
        part = np.exp2((xs - nm[:, None]) * _LOG2E).sum(1, dtype=np.float32)
        s = np.where(active, s * rescale(m, nm) + part, s)
        m = np.where(active, nm, m)
        for e in range(cols.shape[1]):
            take = active & (xs[:, e] > thr)  # strict
            val[take, -1] = xs[take, e]
            col[take, -1] = cols[take, e]
            for i in range(size - 1, 0, -1):
                up = take & (val[:, i] > val[:, i - 1])  # strict
                val[np.ix_(up, [i, i - 1])] = val[np.ix_(up, [i - 1, i])]
                col[np.ix_(up, [i, i - 1])] = col[np.ix_(up, [i - 1, i])]
            thr = np.where(take, np.maximum(thr, val[:, -1]), thr)

    def warp_kth():
        """A lower bound on the k-th largest value met so far: k rounds of
        the maximum head; every lane that holds it pops."""
        heads = val.copy()
        kth = np.float32(-np.inf)
        for _ in range(k):
            kth = heads[:, 0].max()
            pop = heads[:, 0] == kth
            heads[pop] = np.concatenate(
                [heads[pop, 1:], np.full((pop.sum(), 1), -np.inf, np.float32)], 1)
        return kth

    head = min(head, v)
    consume(lanes[:, None], lanes < head)
    nvec = (v - head) // vec
    for c0 in range(0, nvec, 32):  # lane i takes chunks i, i + 32, ...
        chunk = c0 + lanes
        consume(head + chunk[:, None] * vec + np.arange(vec)[None, :],
                chunk < nvec)
        # after the groups 1, 2, 4, ... of UNROLL chunks, while more are to
        # come, the lanes share a bound: later columns must beat it strictly
        group, rest = divmod(c0 // 32 + 1, UNROLL)
        if rest == 0 and group & (group - 1) == 0 and c0 + 32 < nvec:
            thr = np.maximum(thr, warp_kth())
    tail = head + nvec * vec + lanes
    consume(tail[:, None], tail < v)

    for off in (16, 8, 4, 2, 1):
        om, os_ = m[lanes ^ off], s[lanes ^ off]
        nm = np.maximum(m, om)
        s = s * rescale(m, nm) + os_ * rescale(om, nm)
        m = nm

    kv = np.full(32, -np.inf, np.float32)
    kc = np.full(32, _NO_COL, np.int64)
    for r in range(k):
        bv, bc = val[:, 0].copy(), col[:, 0].copy()
        for off in (16, 8, 4, 2, 1):
            ov, oc = bv[lanes ^ off], bc[lanes ^ off]
            take = _before(ov, oc, bv, bc)
            bv, bc = np.where(take, ov, bv), np.where(take, oc, bc)
        kv[r], kc[r] = bv[r], bc[r]
        pop = col[:, 0] == bc
        val[pop] = np.concatenate(
            [val[pop, 1:], np.full((pop.sum(), 1), -np.inf, np.float32)], 1)
        col[pop] = np.concatenate(
            [col[pop, 1:], np.full((pop.sum(), 1), _NO_COL, np.int64)], 1)
    kept = kc[:k].copy()

    have = kc != _NO_COL
    score = np.full(32, -np.inf, np.float32)
    score[have] = kv[have] / np.float32(temp) + noise[kc[have]]
    for off in (16, 8, 4, 2, 1):
        os_, oc, ov = score[lanes ^ off], kc[lanes ^ off], kv[lanes ^ off]
        take = _before(os_, oc, score, kc)  # first index on a tie
        score = np.where(take, os_, score)
        kc, kv = np.where(take, oc, kc), np.where(take, ov, kv)
    conf = np.exp(kv[0] - m[0] - np.log(s[0]), dtype=np.float32)
    return kc[0], conf, kept


def sample_streamed(logits, temperature, k, noise, *, vec=None, misalign=0):
    """The kernel's algorithm on the CPU, lane for lane: each row cut into
    32 lanes x 16-byte chunks of ``vec`` elements (8 for bf16, 4 for fp32;
    default by the logits' type) after ``head`` single elements up to the
    row's first 16-byte boundary (``misalign``: the first row's offset from
    one, in elements), per-lane sorted lists with the strict ``>`` insert
    against the lane's threshold, the bound the lanes share after groups 1,
    2, 4, ... of ``UNROLL`` chunks, the online log-sum-exp, the
    shuffle-tournament merges with their tie rules.  ``noise`` (..., V) is read at the k survivors only.  Returns
    (pred int32, conf fp32, keep bool (..., V))."""
    shape = logits.shape[:-1]
    v = logits.shape[-1]
    if vec is None:
        vec = 16 // logits.element_size()
    if not 1 <= k <= min(v, MAX_K):
        raise ValueError(f'top-k {k} out of range for {v} classes and lists '
                         f'of at most {MAX_K}')
    x = logits.detach().float().reshape(-1, v).numpy()
    g = noise.detach().float().reshape(-1, v).numpy()
    temps = torch.clamp(_row_temperatures(temperature, shape, 'cpu'),
                        min=1e-10).numpy()
    pred = np.zeros(x.shape[0], np.int32)
    conf = np.zeros(x.shape[0], np.float32)
    keep = np.zeros(x.shape, bool)
    for r in range(x.shape[0]):
        head = -(misalign + r * v) % vec
        pred[r], conf[r], kept = _stream_row(x[r], g[r], temps[r], k, vec, head)
        keep[r, kept] = True
    return (torch.from_numpy(pred).reshape(shape),
            torch.from_numpy(conf).reshape(shape),
            torch.from_numpy(keep).reshape(logits.shape))


def order_keys(x, bits=32):
    """The radix kernel's keys: fp32 numpy -> uint32 numpy that order as
    the values do, with -0 and +0 on one key.  ``bits=16``: the top half,
    the kernel's key for bf16 values (whose low half is fixed by the sign)."""
    u = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.uint32)
    keys = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return keys >> np.uint32(32 - bits)


def _radix_pick(hist, remaining):
    """The bin that holds the ``remaining``-th largest counted key, the
    bins taken from the top: (bin, count above it, count in it)."""
    incl = np.cumsum(hist[::-1])
    b = len(hist) - 1 - int(np.argmax(incl >= remaining))
    return b, int(incl[len(hist) - 1 - b] - hist[b]), int(hist[b])


def _radix_row(x, noise, temp, k, bits):
    """One row through the radix kernel.  x, noise: (V,) fp32 numpy; bits:
    key width (16 for bf16 values).  Returns (pred, conf, kept columns,
    whether the buffer overflowed)."""
    keys = order_keys(x, bits).astype(np.int64)
    # pass 1: the first digit over the row
    shift = bits - RADIX_FIRST_BITS
    b, above, inbin = _radix_pick(
        np.bincount(keys >> shift, minlength=1 << RADIX_FIRST_BITS), k)
    prefix, pmask = b << shift, ((1 << RADIX_FIRST_BITS) - 1) << shift
    remaining = k - above
    # the keys at or above the bin into the buffer, in column order; when
    # they overflow it, every later step runs over the row again
    cols = np.flatnonzero(keys >= prefix)
    overflow = len(cols) > RADIX_CAP
    if overflow:
        cols = np.arange(len(x))
    # later passes over the keys matching the prefix, until the chosen bin
    # holds exactly the keys still needed or the key is complete
    while shift > 0 and inbin != remaining:
        width = min(RADIX_LATER_BITS, shift)
        shift -= width
        kk = keys[cols]
        match = kk[(kk & pmask) == prefix]
        d, above, inbin = _radix_pick(np.bincount(
            (match >> shift) & ((1 << width) - 1), minlength=1 << width),
            remaining)
        prefix |= d << shift
        pmask |= ((1 << width) - 1) << shift
        remaining -= above
    # the tied class admitted lowest column first (cols is in column order)
    masked = keys[cols] & pmask
    kept = np.sort(np.concatenate([cols[masked > prefix],
                                   cols[masked == prefix][:remaining]]))
    score = x[kept] / np.float32(temp) + noise[kept]
    best = kept[np.argmax(score)]  # first, so the lower column, on a tie
    m = x.max()
    s = np.exp2((x - m) * _LOG2E).sum(dtype=np.float32)
    return (best, np.exp(x[best] - m - np.log(s), dtype=np.float32), kept,
            overflow)


def sample_radix(logits, temperature, k, noise, *, with_overflow=False):
    """The radix kernel's algorithm on the CPU: order-preserving keys (16-bit
    for bf16 logits, 32-bit for fp32), the first 11-bit pass over the row,
    the keys at or above its bin into the buffer in column order, the later
    passes (5 bits; or 11 and 10) over the buffer or, when it overflows, the
    row, the tied keys admitted lowest column first, the argmax of value /
    temp + noise at the survivors (the lower column on a tie).  Any 1 <= k
    <= V.  Returns (pred int32, conf fp32, keep bool (..., V)) and, with
    ``with_overflow``, whether each row's buffer overflowed (bool (...,))."""
    shape = logits.shape[:-1]
    v = logits.shape[-1]
    if not 1 <= k <= v:
        raise ValueError(f'top-k {k} out of range for {v} classes')
    bits = 16 if logits.dtype == torch.bfloat16 else 32
    x = logits.detach().float().reshape(-1, v).numpy()
    g = noise.detach().float().reshape(-1, v).numpy()
    temps = torch.clamp(_row_temperatures(temperature, shape, 'cpu'),
                        min=1e-10).numpy()
    pred = np.zeros(x.shape[0], np.int32)
    conf = np.zeros(x.shape[0], np.float32)
    keep = np.zeros(x.shape, bool)
    overflow = np.zeros(x.shape[0], bool)
    for r in range(x.shape[0]):
        pred[r], conf[r], kept, overflow[r] = _radix_row(
            x[r], g[r], temps[r], k, bits)
        keep[r, kept] = True
    out = (torch.from_numpy(pred).reshape(shape),
           torch.from_numpy(conf).reshape(shape),
           torch.from_numpy(keep).reshape(logits.shape))
    if with_overflow:
        out += (torch.from_numpy(overflow).reshape(shape),)
    return out


def _kernel(name):
    """The C entry point ``name`` of the sampling library (``sample_fwd`` for
    k <= MAX_K, ``sample_radix_fwd`` above; both take the same arguments),
    with its argument types."""
    if name not in _fns:
        fn = getattr(_build.load('sampling'), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def fused_gumbel_topk_sample(logits, temperature, k=5, *, generator=None):
    """K3 on a CUDA tensor, the plain version (with noise drawn from
    ``generator``) on a CPU tensor.  logits: (..., V) fp32 or bf16,
    contiguous; temperature: scalar or per-sample (B,) (B =
    logits.shape[0]), clamped at 1e-10; any 1 <= k <= V, as the JAX
    function takes: the warp-a-row kernel up to ``MAX_K``, the block-a-row
    radix-select kernel above.  Returns (pred int32 (...,), conf fp32
    (...,))."""
    return _fused_sample(logits, temperature, k, generator, k > MAX_K)


def _fused_sample(logits, temperature, k, generator, radix):
    """``fused_gumbel_topk_sample`` on the kernel ``radix`` names: the
    radix-select kernel (any k) or the warp-a-row one (k <= MAX_K).  Both
    give the same pred on the same seed; ``chip_smoke.py`` holds them
    against each other at a k both take."""
    v = logits.shape[-1]
    if not 1 <= k <= v:
        raise ValueError(f'top-k {k} out of range for {v} classes')
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
    if v >= 2 ** 31:
        raise ValueError(f'{v} classes: columns are 32-bit in the kernel')
    t = logits.numel() // v
    # a host scalar goes in by value; a device scalar or a per-sample (B,)
    # vector by pointer, indexed in the kernel by row // rows_per_temp
    temp = torch.as_tensor(temperature, dtype=torch.float32)
    temp_value, rows_per_temp = 1.0, max(t, 1)
    if temp.ndim == 0 and temp.device.type == 'cpu':
        temp_value, temp = float(temp), None
    elif temp.ndim == 1 and shape and temp.numel() == shape[0]:
        rows_per_temp = max(t // shape[0], 1)
    elif temp.ndim != 0:
        raise ValueError(f'temperature of shape {tuple(temp.shape)} for '
                         f'logits {tuple(logits.shape)}: a scalar or (B,)')
    if temp is not None:
        temp = temp.to(logits.device).reshape(-1).contiguous()
    seed = draw_seed(generator, logits.device)
    pred = torch.empty(shape, dtype=torch.int32, device=logits.device)
    conf = torch.empty(shape, dtype=torch.float32, device=logits.device)
    if t == 0:
        return pred, conf
    global launches, launches_radix
    args = [logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            None if temp is None else temp.data_ptr(), temp_value,
            rows_per_temp, seed.data_ptr(), pred.data_ptr(), conf.data_ptr()]
    if not radix and k > MAX_K:
        raise ValueError(f'top-k {k}: the warp-a-row kernel keeps at most {MAX_K}')
    name = 'sample_radix_fwd' if radix else 'sample_fwd'
    if radix and t >= 2 ** 31:
        raise ValueError(f'{t} rows: the radix kernel takes fewer than 2**31')
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        err = _kernel(name)(*args, t, v, k, stream)
    _build.check(err, 'sampling')
    if radix:
        launches_radix += 1
    else:
        launches += 1
    return pred, conf
