"""The routed FFN's experts on the kept assignments only (kernel K5), the
packing and combine around it, and their plain versions.

Replaces no TPU kernel: the JAX package computes ``nn/moe.py``'s dispatch,
experts and combine with XLA.  The port ran them as a capacity-padded
(E, C, D) buffer through a ``torch.baddbmm`` pair, which multiplies every
one of the E·C slots, filled or not (at the benchmark's seeded router 52 %
of the assignments are kept, 41.5 % of the slots), with the SwiGLU's
``chunk``, ``silu`` and ``mul`` as three more passes over the whole padded
hidden.  Here the kept assignments are packed by expert and the experts run
on those rows alone:

  * ``dispatch``: from the routing's ``idx``, ``pos`` and ``keep``, each
    expert's rows ``off[e] .. off[e + 1] - 1`` (its queued assignments,
    ``pos < cap``, in queue order: row ``off[idx] + pos``), the (T, k)
    assignment -> row map (-1 for a dropped one) and the packed tokens.  On
    the card a one-block count and a copy pass; no ``.item()``, no
    ``nonzero``, no boolean indexing, so the host never waits; the buffers
    have the static worst-case ``min(k·T, E·C)`` rows.
  * ``grouped_swiglu``: K5a, ``H = silu(X·W1ᵀ + b1) · (X·W2ᵀ + b2)`` with the
    SwiGLU in the product's epilogue (fp32, one rounding), then K5b,
    ``O = H·W3ᵀ + b3``, each expert's weights on its own rows.
  * ``combine``: ``y[t] = Σ_j g[t, j] · O[row(t, j)]`` in fp32, rounded once,
    a dropped assignment adding nothing (``moe_swiglu``'s batched-product
    combine, without the padded copy it gathered from).

What bounds K5 on an H100: operations, 6·D·h a kept row (12.8 GFLOP a call at
the benchmark's 34 k rows of D = 1024, h = 2736: 1.04 ms at 989 TFLOP/s),
against some 0.2 GB of operands.  The kernels (``csrc/moe_experts.cu``) are
persistent grouped GEMMs: one block an SM walks (expert, 128-row tile,
column tile) tiles, a producer thread keeps a four-stage TMA ring of 64-deep
stages full and two warpgroups run ``wgmma`` out of it with fp32
accumulators; the tile table comes from ``off`` on the device.  K5a's tile
is 144 columns of H and holds the matching rows of both halves of w12
(2736 = 19 · 144), K5b's 256 columns of O.  No atomics and no split of the
depth: the same bits every run.  ``grouped_swiglu_tiled`` is the kernels'
schedule and arithmetic, tile by tile, on the CPU.

Up to 128 experts (SDAR-30B-A3B's count), and experts without biases:
``b12`` and ``b3`` may be None (the kernels then load and add nothing).  A
hidden width that is not a multiple of K5a's 144 columns (SDAR's 768) ends in
a ragged column tile, computed and not stored past h.

The wrappers take the plain versions for a tensor on the CPU, launch the
kernels for a bf16 tensor on the card, and raise otherwise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

launches = 0  # K5 calls so far (K5a then K5b); chip_smoke.py resets and reads it

BLOCK_ROWS = 128   # rows of a tile (BM in the kernel)
W12_COLS = 144     # K5a: columns of H a tile
W3_COLS = 256      # K5b: columns of O a tile
DEPTH = 64         # depth of a ring stage (BK)
MAX_EXPERTS = 128
_fns = {}
_sms = {}


def pack_rows_plain(idx, pos, keep, cap, num_experts):
    """The packed layout of a routing (``nn.moe.route``'s ``idx``, ``pos``,
    ``keep``, ``cap``) -> ``(off, row_token, row)``: ``off`` (E + 1,) int32,
    expert e's rows ``off[e] .. off[e + 1] - 1``, one for each of its queued
    assignments (``pos < cap``: ``min(count, cap)`` of them; an assignment
    queued with gate 0 keeps its row and is not read); ``row_token``
    (``min(k·T, E·cap)``,) int32, the token of each row below ``off[E]``
    (0 past it); ``row`` (T, k) int32, each kept assignment's row, -1 where
    it is dropped.  Tensor code without a host synchronisation."""
    t, k = idx.shape
    rows_max = min(t * k, num_experts * cap)
    dev = idx.device
    counts = (idx.reshape(-1, 1) == torch.arange(num_experts, device=dev)).sum(0)
    off = F.pad(counts.clamp(max=cap).cumsum(0), (1, 0))      # (E + 1,)
    row = off[idx] + pos                                      # (T, k)
    tokens = torch.arange(t, dtype=torch.int32, device=dev)[:, None].expand(t, k)
    # rows are unique; every unqueued assignment lands in the spare last row
    row_token = torch.zeros(rows_max + 1, dtype=torch.int32, device=dev)
    row_token.index_put_((torch.where(pos < cap, row, rows_max).reshape(-1),),
                         tokens.reshape(-1))
    return off.int(), row_token[:rows_max], torch.where(keep, row, -1).int()


def dispatch_plain(xt, idx, pos, keep, cap, num_experts):
    """``pack_rows_plain`` and the packed tokens: ``(off, row, xp)``, xp
    (``min(k·T, E·cap)``, D) holding row r's token (token 0 past
    ``off[E]``)."""
    off, row_token, row = pack_rows_plain(idx, pos, keep, cap, num_experts)
    return off, row, xt[row_token.long()]


def dispatch(xt, idx, pos, keep, cap, num_experts):
    """The packed layout of a routing and the packed tokens, ``(off, row,
    xp)`` as ``dispatch_plain`` gives them: the plain version on the CPU; on
    the card two kernels, a one-block count of each expert's rows (integer
    atomics in shared memory: exact counts) and a pass a warp an assignment
    that places it and
    copies its token (rows of xp from ``off[E]`` on unset).  They read the
    routing's tensors in their strides; the host never waits."""
    if xt.device.type == 'cpu':
        return dispatch_plain(xt, idx, pos, keep, cap, num_experts)
    if xt.device.type != 'cuda':
        raise ValueError(f'dispatch: device {xt.device}')
    _bf16_on_card('dispatch', xt)
    t, d = xt.shape
    k = idx.shape[1]
    if (idx.dtype != torch.int64 or pos.dtype != torch.int64
            or keep.dtype != torch.bool or idx.shape != (t, k)
            or pos.shape != (t, k) or keep.shape != (t, k)
            or not idx.device == pos.device == keep.device == xt.device
            or num_experts > MAX_EXPERTS or d % 8):
        raise ValueError(
            f'dispatch kernel takes (T, k) int64 idx and pos, bool keep, at '
            f'most {MAX_EXPERTS} experts and a width that is a multiple of 8: '
            f'x {tuple(xt.shape)}, {idx.dtype} {tuple(idx.shape)}, {pos.dtype} '
            f'{tuple(pos.shape)}, {keep.dtype} {tuple(keep.shape)}, '
            f'{num_experts} experts, devices {idx.device} {pos.device} '
            f'{keep.device}')
    _check_card('dispatch', xt)
    dev = xt.device
    off = torch.empty(num_experts + 1, dtype=torch.int32, device=dev)
    row = torch.empty(t, k, dtype=torch.int32, device=dev)
    xp = torch.empty(min(t * k, num_experts * cap), d, dtype=xt.dtype,
                     device=dev)
    _launch('moe_dispatch', xt.data_ptr(), idx.data_ptr(), pos.data_ptr(),
            keep.data_ptr(), *idx.stride(), *pos.stride(), *keep.stride(), t,
            k, num_experts, cap, d, _sm_count(dev), off.data_ptr(),
            row.data_ptr(), xp.data_ptr(), device=dev)
    return off, row, xp


def _sm_count(device):
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {  # pointers, then sizes, then the stream
    'moe_experts': [_P] * 8 + [_I] * 6 + [_P],
    'moe_dispatch': [_P] * 4 + [_L] * 6 + [_I] * 6 + [_P] * 3 + [_P],
    'moe_combine': [_P] * 4 + [_I] * 4 + [_P],
}


def _kernel(name):
    if name not in _fns:
        fn = getattr(_build.load('moe_experts'), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_card(what, *tensors):
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f'{what}: tensors on {dev} and {x.device}')
        if not x.is_contiguous():
            raise ValueError(f'{what} kernel takes contiguous operands')
        if x.data_ptr() % 16:
            raise ValueError(f'{what} kernel takes 16-byte aligned operands')


def _launch(name, *args, device):
    """One C entry point on the current stream of ``device``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if torch.cuda.current_device() == device.index:
        err = _kernel(name)(*args, stream)
    else:
        with torch.cuda.device(device):
            err = _kernel(name)(*args, stream)
    _build.check(err, name)


def _bf16_on_card(what, *tensors):
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise TypeError(f'{what} kernel takes bf16 operands, got '
                        f'{[x.dtype for x in tensors]}')


def _shape(t):
    return None if t is None else tuple(t.shape)


def _ptr(t):
    """A bias's address, or null for experts without biases."""
    return None if t is None else t.data_ptr()


def _bias(b, e):
    """Expert e's bias in fp32, or 0 for experts without biases."""
    return 0.0 if b is None else b[e].float()


def grouped_swiglu_plain(xp, off, w12, b12, w3, b3):
    """Each expert's packed rows through its SwiGLU: sums in fp32, H rounded
    to the rows' type once (after ``silu(x1)·x2``), O once.  xp (rows, D),
    w12 (E, 2h, D), b12 (E, 2h) or None, w3 (E, D, h), b3 (E, D) or None
    -> O (rows, D), zero past ``off[E]``."""
    hidden = w12.shape[1] // 2
    out = xp.new_zeros(xp.shape[0], w3.shape[1])
    bounds = off.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        a = xp[lo:hi].float() @ w12[e].float().t() + _bias(b12, e)
        h = (F.silu(a[:, :hidden]) * a[:, hidden:]).to(xp.dtype)
        out[lo:hi] = (h.float() @ w3[e].float().t() + _bias(b3, e)).to(xp.dtype)
    return out


def _tile_table(bounds, n_out, cols):
    """K5's tiles in the order the blocks take them: expert, row tile,
    column tile (fastest): ``(e, row0, row_end, col0)``."""
    n_tiles = -(-n_out // cols)
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        for m in range(-(-(hi - lo) // BLOCK_ROWS)):
            for n in range(n_tiles):
                yield e, lo + m * BLOCK_ROWS, hi, n * cols


def _tile_sums(a, b_flat, row0, b_row0, cols):
    """One tile's fp32 sums: rows row0 .. + 127 of ``a`` against rows b_row0
    .. + cols - 1 of ``b_flat`` (both (rows, K)), zeros past either's rows
    (the TMA unit's fill), the depth in 64-deep steps (the last one
    zero-filled past K)."""
    depth = a.shape[1]
    at = F.pad(a[row0:row0 + BLOCK_ROWS].float(),
               (0, 0, 0, max(0, row0 + BLOCK_ROWS - a.shape[0])))
    bt = F.pad(b_flat[b_row0:b_row0 + cols].float(),
               (0, 0, 0, max(0, b_row0 + cols - b_flat.shape[0])))
    acc = torch.zeros(BLOCK_ROWS, cols)
    for k0 in range(0, depth, DEPTH):
        acc += at[:, k0:k0 + DEPTH] @ bt[:, k0:k0 + DEPTH].t()
    return acc


def _store(out, written, val, row0, row_end, col0):
    """The epilogue's stores: rows below the expert's end, columns below the
    output's width; each element written once."""
    rows = min(BLOCK_ROWS, row_end - row0)
    cols = min(val.shape[1], out.shape[1] - col0)
    if written[row0:row0 + rows, col0:col0 + cols].any():
        raise AssertionError(f'tile at ({row0}, {col0}) written twice')
    out[row0:row0 + rows, col0:col0 + cols] = val[:rows, :cols].to(out.dtype)
    written[row0:row0 + rows, col0:col0 + cols] = True


def grouped_swiglu_tiled(xp, off, w12, b12, w3, b3):
    """K5a then K5b tile by tile on the CPU, as the blocks run them: the
    tile table from ``off`` (each expert ``ceil(n_e / 128)`` row tiles, each
    of ``ceil(n_out / cols)`` column tiles); a tile's 128 rows start at the
    expert's row and run on past its count (into the next expert's rows, or
    the buffer's unset ones: NaN here), computed with this expert's weights
    and not stored; K5a's tile holds the same 144 columns of both halves of
    w12; sums in fp32 over 64-deep steps; the epilogue adds the bias, forms
    ``silu(x1)·x2`` in fp32 and rounds once.  H and O start as NaN past
    ``off[E]`` and every element below it must be written exactly once."""
    rows, d = xp.shape
    e_count, h2, _ = w12.shape
    hidden = h2 // 2
    bounds = off.tolist()
    total = bounds[-1]
    xp = xp.clone()
    xp[total:] = float('nan')  # the rows the gather pass leaves unset
    w12f, w3f = w12.reshape(e_count * h2, d), w3.reshape(e_count * d, hidden)
    h = xp.new_full((rows, hidden), float('nan'))
    written = torch.zeros(rows, hidden, dtype=torch.bool)
    for e, row0, row_end, n0 in _tile_table(bounds, hidden, W12_COLS):
        x1 = _tile_sums(xp, w12f, row0, e * h2 + n0, W12_COLS)
        x2 = _tile_sums(xp, w12f, row0, e * h2 + hidden + n0, W12_COLS)
        end = min(hidden, n0 + W12_COLS)  # the epilogue reads no bias past h
        b1 = b2 = 0.0
        if b12 is not None:
            b1 = F.pad(b12[e, n0:end].float(), (0, n0 + W12_COLS - end))
            b2 = F.pad(b12[e, hidden + n0:hidden + end].float(),
                       (0, n0 + W12_COLS - end))
        _store(h, written, F.silu(x1 + b1) * (x2 + b2), row0, row_end, n0)
    if not written[:total].all():
        raise AssertionError('K5a left a row of H unwritten')
    o = xp.new_full((rows, d), float('nan'))
    written = torch.zeros(rows, d, dtype=torch.bool)
    for e, row0, row_end, n0 in _tile_table(bounds, d, W3_COLS):
        acc = _tile_sums(h, w3f, row0, e * d + n0, W3_COLS)
        bias = 0.0 if b3 is None else F.pad(b3[e, n0:n0 + W3_COLS].float(),
                                            (0, max(0, n0 + W3_COLS - d)))
        _store(o, written, acc + bias, row0, row_end, n0)
    if not written[:total].all():
        raise AssertionError('K5b left a row of O unwritten')
    return o


def grouped_swiglu(xp, off, w12, b12, w3, b3):
    """K5a and K5b on a bf16 tensor on the card (the rows past ``off[E]``
    of the result unset), the plain version on the CPU.  xp (rows, D) with
    D a multiple of 8; w12 (E, 2h, D), h a multiple of 8; b12 (E, 2h); w3
    (E, D, h); b3 (E, D); off (E + 1,) int32 -> O (rows, D).  b12 and b3
    are both None for experts without biases."""
    if xp.device.type == 'cpu':
        return grouped_swiglu_plain(xp, off, w12, b12, w3, b3)
    if xp.device.type != 'cuda':
        raise ValueError(f'grouped_swiglu: device {xp.device}')
    biases = [b for b in (b12, b3) if b is not None]
    _bf16_on_card('grouped_swiglu', xp, w12, w3, *biases)
    rows, d = xp.shape
    e, h2, d_in = w12.shape
    hidden = h2 // 2
    if (d_in != d or h2 % 2 or len(biases) == 1
            or (b12 is not None and (tuple(b12.shape) != (e, h2)
                                     or tuple(b3.shape) != (e, d)))
            or tuple(w3.shape) != (e, d, hidden)
            or tuple(off.shape) != (e + 1,)):
        raise ValueError(f'grouped_swiglu: shapes x {tuple(xp.shape)}, w12 '
                         f'{tuple(w12.shape)}, b12 {_shape(b12)}, w3 '
                         f'{tuple(w3.shape)}, b3 {_shape(b3)}, off '
                         f'{tuple(off.shape)}')
    if d % 8 or hidden % 8 or e > MAX_EXPERTS or off.dtype != torch.int32:
        raise ValueError(f'grouped_swiglu kernel takes widths that are '
                         f'multiples of 8, at most {MAX_EXPERTS} experts and '
                         f'int32 offsets: D {d}, h {hidden}, E {e}, {off.dtype}')
    _check_card('grouped_swiglu', xp, off, w12, w3, *biases)
    h = torch.empty(rows, hidden, dtype=xp.dtype, device=xp.device)
    out = torch.empty(rows, d, dtype=xp.dtype, device=xp.device)
    _launch('moe_experts', xp.data_ptr(), w12.data_ptr(), _ptr(b12),
            w3.data_ptr(), _ptr(b3), off.data_ptr(), h.data_ptr(),
            out.data_ptr(), rows, d, hidden, e, 3, _sm_count(xp.device),
            device=xp.device)
    global launches
    launches += 1
    return out


def combine_plain(o, row, gate):
    """(rows, D) expert outputs, (T, k) rows (-1: dropped) and gates ->
    (T, D): one (1, k) x (k, D) product a token (the k terms in fp32, one
    rounding), a dropped assignment reading a zero row."""
    t, k = row.shape
    spare = F.pad(o, (0, 0, 0, 1))
    picked = spare[torch.where(row < 0, o.shape[0], row).long()].view(t, k, -1)
    return torch.bmm(gate.to(o.dtype)[:, None, :], picked)[:, 0]


def combine(o, row, gate):
    """The gated sum of each token's rows: the plain version on the CPU;
    on the card one pass, a warp a token, that reads only the kept rows."""
    if o.device.type == 'cpu':
        return combine_plain(o, row, gate)
    if o.device.type != 'cuda':
        raise ValueError(f'combine: device {o.device}')
    _bf16_on_card('combine', o, gate)
    if row.dtype != torch.int32 or row.shape != gate.shape:
        raise ValueError(f'combine: rows {row.dtype} {tuple(row.shape)}, '
                         f'gates {tuple(gate.shape)}')
    d = o.shape[1]
    if d % 8:
        raise ValueError(f'combine kernel takes a width that is a multiple '
                         f'of 8, got {d}')
    # the gates may be a transposed view of the routing's slot-major work
    row, gate = row.contiguous(), gate.contiguous()
    _check_card('combine', o, row, gate)
    t, k = row.shape
    y = torch.empty(t, d, dtype=o.dtype, device=o.device)
    _launch('moe_combine', o.data_ptr(), row.data_ptr(), gate.data_ptr(),
            y.data_ptr(), t, k, d, _sm_count(o.device), device=o.device)
    return y
