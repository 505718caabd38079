"""Fused codebook nearest-neighbour lookup (kernel K2) and its plain version.

Replaces ``paintmind_tpu/ops/vq_lookup.py::_fused_nearest_codes`` (Pallas
kernel ``_lookup_kernel``): for l2-normalised queries z (T, D) and codebook
rows e (C, D), ``argmax_j z·e_j`` with ties to the lowest index.  The kernel
is compiled for code dims 8, 16 and 32, and walks wider codes in chunks of
64 (``kernel_code_dim``); the wrapper zero-pads any other dim up to the
next, which changes no score.

What bounds it on an H100: the 2*T*C*D fp32 operations (4.3 GFLOP at
T = 8 x 1024, C = 8192); the operands are only ~2 MB.  They run as FFMA on
the CUDA cores (one tensor-core pass would pick other codes), and what holds
FFMA back is the shared-memory loads beside it.  The kernel
(``csrc/vq_lookup.cu``) is therefore a register-tiled product: a block owns
64 tokens and streams the codebook through a two-stage ``cp.async`` ring in
tiles of 128 codes, a thread holds 4 x 8 scores in registers and folds them
into a running (best value, best index) per token, so the (T, C) score
matrix (268 MB at that size) never exists.  Where T / 64 blocks would leave
most of the card idle (one image is 16 blocks on 132 SMs) the codebook is
also split over blocks, whose bests meet in a 64-bit ``atomicMax`` on
(ordered score bits, complemented index): order-independent, so every run
gives the same bits and ties still go to the lowest index.
``nearest_codes_tiled`` is the kernel's selection, thread for thread, on the
CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

BLOCK_TOKENS = 64   # tokens per block (BT in the kernel)
TILE_CODES = 128    # codes per shared-memory tile (BC)
THREAD_CODES = 8    # codes per thread (TN)
_fn = None


def kernel_code_dim(d):
    """The code dim the kernel runs a code dim ``d`` at: 8, 16, 32, or the
    next multiple of 64 (walked in chunks of 64)."""
    if d < 1:
        raise ValueError(f'code dim {d}')
    for c in (8, 16, 32):
        if d <= c:
            return c
    return -(-d // 64) * 64


def nearest_codes_plain(z_norm, codebook_norm):
    """z_norm: (..., D); codebook_norm: (C, D) -> int32 (...,)."""
    sim = z_norm.float() @ codebook_norm.float().t()
    return torch.argmax(sim, dim=-1).to(torch.int32)


def codebook_splits(t, c, sm_count):
    """How many blocks share one token tile's walk over the codebook: as
    many as bring the grid to about two blocks per SM, at most one per
    codebook tile.  1 when the token tiles alone fill the card."""
    blocks = -(-t // BLOCK_TOKENS)
    tiles = -(-c // TILE_CODES)
    return max(1, min(tiles, 2 * sm_count // blocks))


def ordered_bits(scores):
    """fp32 numpy array -> uint32 whose unsigned order is the floats' order
    (negative, zero, positive), with -0 made +0 first."""
    u = (np.asarray(scores, np.float32) + np.float32(0)).view(np.uint32)
    return u ^ np.where(u >> 31, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def pack_key(scores, index):
    """The 64-bit key whose maximum is the greatest score at its lowest
    index: ordered score bits over the complemented index."""
    return (ordered_bits(scores).astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - np.asarray(index).astype(np.uint64))


def _before(av, ai, bv, bi):
    return (av > bv) | ((av == bv) & (ai < bi))


def nearest_codes_tiled(z_norm, codebook_norm, splits=1):
    """The kernel's selection on the CPU, thread for thread.  The fp32
    scores come from one matrix product (the kernel's own sums differ from
    it in their order, which the card's gate covers); what is emulated is
    everything that decides a tie: blocks of 64 tokens, tiles of 128 codes
    with the ragged last one masked by index, a thread's 8 codes of a tile
    (cl, cl + 16, ...) folded under a strict ``>`` in ascending order, the
    merge over the eight code lanes of a warp by xor-shuffles and over the
    two warps through shared memory under (greater value, or equal value
    and lower index), and for ``splits`` > 1 the maximum of the packed
    64-bit keys over the splits.  Returns int32 (...,)."""
    shape = z_norm.shape[:-1]
    z = z_norm.detach().float().reshape(-1, z_norm.shape[-1])
    scores = (z @ codebook_norm.detach().float().t()).numpy()
    t, c = scores.shape
    tiles = -(-c // TILE_CODES)
    if not 1 <= splits <= tiles:
        raise ValueError(f'{splits} splits for {tiles} codebook tiles')
    per_split = -(-tiles // splits)
    code_lanes = TILE_CODES // THREAD_CODES
    keys = np.zeros(t, np.uint64)
    out = np.zeros(t, np.int32)
    lanes = np.arange(8)
    for first in range(0, tiles, per_split):
        # best[token, code lane] over this split's tiles
        best = np.full((t, code_lanes), -np.inf, np.float32)
        arg = np.full((t, code_lanes), first * TILE_CODES, np.int64)
        for tile in range(first, min(tiles, first + per_split)):
            for i in range(THREAD_CODES):  # ascending codes per thread
                code = tile * TILE_CODES + i * code_lanes + np.arange(code_lanes)
                ok = code < c
                s = scores[:, np.where(ok, code, 0)]
                take = ok[None, :] & (s > best)  # strict
                best = np.where(take, s, best)
                arg = np.where(take, code[None, :], arg)
        halves = []
        for w in range(2):  # the two warps that split a tile's codes
            bv, bi = best[:, 8 * w:8 * w + 8], arg[:, 8 * w:8 * w + 8]
            for off in (1, 2, 4):
                ov, oi = bv[:, lanes ^ off], bi[:, lanes ^ off]
                take = _before(ov, oi, bv, bi)
                bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
            halves.append((bv[:, 0], bi[:, 0]))
        (bv, bi), (ov, oi) = halves
        take = _before(ov, oi, bv, bi)
        bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
        if splits == 1:
            out = bi.astype(np.int32)
        else:
            keys = np.maximum(keys, pack_key(bv, bi))
    if splits > 1:
        out = (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF))).astype(np.int32)
    return torch.from_numpy(out).reshape(shape)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load('vq_lookup').vq_lookup_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_nearest_codes(z_norm, codebook_norm):
    """K2 on a CUDA tensor, the plain version on a CPU tensor.  z_norm:
    (..., D) fp32, codebook_norm: (C, D) fp32 -> int32 (...,), any D (the
    kernel sees both zero-padded to ``kernel_code_dim(D)``)."""
    if z_norm.device.type == 'cpu':
        return nearest_codes_plain(z_norm, codebook_norm)
    if z_norm.device.type != 'cuda' or codebook_norm.device != z_norm.device:
        raise ValueError(f'fused_nearest_codes: devices {z_norm.device}, '
                         f'{codebook_norm.device}')
    if z_norm.dtype != torch.float32 or codebook_norm.dtype != torch.float32:
        raise TypeError('fused_nearest_codes kernel takes fp32 operands, got '
                        f'{z_norm.dtype}, {codebook_norm.dtype}')
    if codebook_norm.ndim != 2 or codebook_norm.shape[1] != z_norm.shape[-1]:
        raise ValueError(f'fused_nearest_codes: code dims of z '
                         f'{tuple(z_norm.shape)} and codebook '
                         f'{tuple(codebook_norm.shape)} differ')
    if not (z_norm.is_contiguous() and codebook_norm.is_contiguous()):
        raise ValueError('fused_nearest_codes kernel takes contiguous operands')
    if z_norm.data_ptr() % 16 or codebook_norm.data_ptr() % 16:
        raise ValueError('fused_nearest_codes kernel takes 16-byte aligned '
                         'operands')
    shape = z_norm.shape[:-1]
    dim = z_norm.shape[-1]
    t = z_norm.numel() // dim
    kdim = kernel_code_dim(dim)
    if kdim != dim:  # zero columns: the same scores
        z_norm = torch.nn.functional.pad(z_norm, (0, kdim - dim))
        codebook_norm = torch.nn.functional.pad(codebook_norm, (0, kdim - dim))
    out = torch.empty(shape, dtype=torch.int32, device=z_norm.device)
    if t == 0:
        return out
    c = codebook_norm.shape[0]
    splits = codebook_splits(t, c, torch.cuda.get_device_properties(
        z_norm.device).multi_processor_count)
    keys = torch.zeros(t, dtype=torch.int64, device=z_norm.device) \
        if splits > 1 else None
    global launches
    stream = torch.cuda.current_stream(z_norm.device).cuda_stream
    with torch.cuda.device(z_norm.device):
        err = _kernel()(z_norm.data_ptr(), codebook_norm.data_ptr(),
                        out.data_ptr(),
                        None if keys is None else keys.data_ptr(), t, c,
                        kdim, splits, stream)
    _build.check(err, 'vq_lookup')
    launches += 1
    return out
