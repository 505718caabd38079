#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paintmind_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py K3 K3r     # build and check these kernels only, then
                                     # stop (a short first run after a kernel
                                     # edit; prints no result line)

Phases, each printed on its own line(s); any failure raises and the script
exits non-zero with no result line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. builds kernels K1-K4 from the sources in this checkout (one ``nvcc``
     per CUDA source, all at once), prints each kernel's registers, shared
     memory and spills, and checks in the compiled code that the bf16
     attention kernels run their products on the tensor cores (``HGMMA`` in
     the SASS) and that no kernel spills;
  3. holds each kernel against its plain PyTorch version at the main
     path's shapes, and times kernel, plain version and (where one exists)
     the PyTorch library call, beside the least time the card could take;
     K1 and K4 also at head dims 128 and 32, K1 at N = M = 4096 (the 512²
     variant), K2 at code dims 8, 16, 12, 48 and 100;
  4. stage 1: the shipped vit-s-vqgan weights reconstruct 8 seeded 256²
     images through the kernels and through the plain versions; then a
     registered model of head dim 16 and code dim 8 runs ``generate``,
     ``reconstruct`` and a training microbatch through the kernels; then
     the 512² variant: ``adapt_vqmodel_resolution`` of the shipped weights
     reconstructs at 4096 tokens against the plain versions, and a seeded
     ``paintmindv1-512`` generates in fp32 (against the plain attention)
     and in bf16 (timed), through K1, K3 and the re-mask's sort route;
  5. stage 2: a full-width paintmindv1 pipeline (seeded random stage-2
     weights, bf16) runs a 16-step ``generate`` at B = 8, the same with
     classifier-free guidance, and an ``inpaint``; the launch counters must
     show each kernel on that path, at the expected counts;
  6. serving: ``make_server`` over a ``GenerationEngine`` over a
     full-width bf16 ``paintmindv1`` with a full-width flan-t5-large text
     tower (seeded random weights): one concurrent HTTP burst of prompted
     /generate (top-k 5 and 32, with and without guidance), /reconstruct,
     /inpaint and /outpaint requests and one malformed request; launches
     checked against the batches the engine ran; requests/s and latency;
     a seeded batch twice, bit-equal; the engine against a direct
     ``generate``; /variations through a ViT-L/14 image tower;
  7. stage-2 training at the same width (fp32 master weights, bf16
     compute): one microbatch of B = 8 through ``pipeline_loss`` and
     ``backward()`` with the kernels and with the plain attention, loss and
     gradients compared; its launch counts without and with remat; six
     updates of the step function (Lion, dropout on, two microbatches
     each), timed; a short ``PaintMindTrainer.train()`` with ``save()``,
     ``resume('auto')`` into a second trainer and one ``evaluate()``;
     then stage-1 (VQGAN) training at vit-s-vqgan width from the shipped
     weights: one microbatch's G loss and gradients with the kernels and
     with the plain versions, five timed updates of
     ``make_vqgan_train_step`` (share_forward, two microbatches, EMA) with
     their launch counts and peak memory, and a ``VQGANTrainer.train()``
     with ``save()``, ``resume('auto')`` and one ``evaluate()``; then the
     command lines, in process at full width on 40 seeded JPEGs:
     ``train_vqgan`` -> ``train_paintmind`` on its export -> ``generate``
     (and ``--mode inpaint``) on that export, and ``convert_checkpoint`` of
     a seeded reference-layout ``.pt``;
  8. ``torch.profiler`` windows over one unguided ``generate``, one stage-2
     training microbatch and one stage-1 microbatch: the ten device
     operations with the most time, and the device's busy share of each
     window (report only);
  9. one ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero when there is none.
"""

import base64
import gc
import hashlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

import paintmind_tpu_torch as pt
from paintmind_tpu_torch.models import quantize as tq
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.models.pipeline import (
    _transformer_logits, ids_to_tokens, pipeline_loss)
from paintmind_tpu_torch.ops import _build
from paintmind_tpu_torch.ops import flash_attention as fa
from paintmind_tpu_torch.ops import sampling as sm
from paintmind_tpu_torch.ops import vq_lookup as vq
from paintmind_tpu_torch.serving import (GenerateRequest, GenerationEngine,
                                         make_server)
from paintmind_tpu_torch.train.steps import (make_pipeline_train_step,
                                             make_vqgan_train_step,
                                             vqgan_g_loss)
from paintmind_tpu_torch.utils.checkpoint import load_flat

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, 'paintmind_tpu', 'assets', 'vit_vq_photo.npz')

# H100 SXM data sheet, dense: HBM bytes/s, bf16 tensor-core and fp32
# (CUDA-core) operations/s.  Rated at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
CARD = ''  # name and power limit as nvidia-smi gives them; set in main()

# kernel -> (module, name of its launch counter there)
KERNEL_COUNTERS = {'K1': (fa, 'launches'), 'K2': (vq, 'launches'),
                   'K3': (sm, 'launches'), 'K3r': (sm, 'launches_radix'),
                   'K4': (fa, 'launches_bwd')}


def log(*parts):
    print(*parts, flush=True)


def reset_counts():
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def median_ms(fn, iters):
    """Median milliseconds of ``iters`` calls, each timed alone with CUDA
    events, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_ms(fn, iters):
    """Mean device milliseconds per call over ``iters`` calls, CUDA events,
    after two warm-up calls.  The calls are queued behind a device-side
    sleep of some 20 ms, so that a kernel shorter than its wrapper's host
    time is timed at the device's rate and not at the host's."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, dtype):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate for the inputs' type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def mean_rel(got, ref):
    """Mean absolute error over the reference's mean magnitude."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().mean() / ref.abs().mean()).item()


# (label, B, N, M, H, D, timed): the main path's shapes at D = 64, the
# other head dims the kernels take (D = 128 compiled, D = 32 zero-padded to
# 64 by the wrapper), and ragged edges at each
ATTN_CASES = (('stage-2 self', 8, 1024, 1024, 16, 64, True),
              ('stage-2 cross', 8, 1024, 77, 16, 64, True),
              ('vqgan self', 8, 1024, 1024, 8, 64, True),
              ('vqgan self', 8, 1024, 1024, 8, 128, True),
              ('vqgan self', 8, 1024, 1024, 8, 32, True),
              ('ragged', 2, 200, 77, 3, 64, False),
              ('ragged', 2, 200, 77, 3, 128, False),
              ('ragged', 2, 200, 77, 3, 32, False))
# K1 only: the 512² variant's self-attention (4096 tokens), which the 512²
# phase runs; K4 at 4096 tokens (512² training) is not on a path yet
K1_ONLY_CASES = (('512² self', 2, 4096, 4096, 16, 64, True),)


def check_k1(g):
    """K1 against ``flash_attention_plain`` at stage-2 self (H = 16,
    M = 1024), cross (M = 77) and VQGAN (H = 8) attention at B = 8 and a
    ragged case (B = 2, N = 200, M = 77, H = 3), fp32 and bf16, at head dim
    64 and, for the VQGAN and ragged shapes, at 128 and 32 (``ATTN_CASES``).  Gates: fp32
    max abs <= 1e-4; bf16 mean abs <= 5e-3 (the kernel rounds the
    unnormalised p to bf16 and divides by the fp32 sum afterwards, the plain
    version rounds the normalised probabilities: measured 3e-4 at most, one
    bf16 rounding of values below 1), and mean abs <= 1e-5 against the tiled
    emulation, which rounds where the kernel does (measured 2e-7: only the
    order of the fp32 sums and the hardware's exp2 differ).  The log-sum-exp
    output against ``torch.logsumexp`` of the fp32 scaled scores: max abs
    <= 1e-3 in bf16 (measured 1e-6), <= 1e-5 in fp32.  The same gates at
    N = M = 4096 (B = 2, H = 16: the 512² variant; the plain version then
    holds B·H·4096² fp32 scores, 2 GiB).  Times the unragged shapes; the
    result line carries the main path's most frequent call, stage-2
    self-attention in bf16."""
    entry = None
    for label, b, n, m, h, d, timed in ATTN_CASES + K1_ONLY_CASES:
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, n, h, d, device='cuda', generator=g).to(dtype)
            k = torch.randn(b, m, h, d, device='cuda', generator=g).to(dtype)
            v = torch.randn(b, m, h, d, device='cuda', generator=g).to(dtype)
            out = fa.flash_attention(q, k, v, scale)
            out2, lse = fa._launch_forward(q, k, v, scale, with_lse=True)
            check(torch.equal(out, out2), f'K1 {label}: asking for the '
                  'log-sum-exp changed the output')
            ref = fa.flash_attention_plain(q, k, v, scale)
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            want_lse = torch.logsumexp(torch.einsum(
                'bnhd,bmhd->bhnm', q.float(), k.float()) * scale, dim=-1)
            lse_err = (lse - want_lse).abs().max().item()
            check(bool(torch.isfinite(out).all()), f'K1 {label} not finite')
            if dtype == torch.float32:
                check(max_err <= 1e-4, f'K1 {label} fp32 max err {max_err}')
                check(lse_err <= 1e-5, f'K1 {label} fp32 lse err {lse_err}')
                tiled = ''
            else:
                emu = fa.flash_attention_tiled(q, k, v, scale)[0]
                emu_err = (out.float() - emu.float()).abs().mean().item()
                check(mean_err <= 5e-3, f'K1 {label} bf16 mean err {mean_err}')
                check(emu_err <= 1e-5, f'K1 {label} bf16 mean err against '
                      f'the tiled emulation {emu_err}')
                check(lse_err <= 1e-3, f'K1 {label} bf16 lse err {lse_err}')
                tiled = f' vs_tiled_mean_abs={emu_err:.3e}'
            line = (f'K1 {label} B={b} N={n} M={m} H={h} D={d} '
                    f'{str(dtype)[6:]}: max_abs_err={max_err:.3e} '
                    f'mean_abs_err={mean_err:.3e}{tiled} '
                    f'lse_max_abs_err={lse_err:.3e}')
            if timed:
                ms = time_ms(lambda: fa.flash_attention(q, k, v, scale), 20)
                plain_ms = time_ms(
                    lambda: fa.flash_attention_plain(q, k, v, scale), 5)
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    scale=scale), 20)
                nbytes = ((2 * b * n * h * d + 2 * b * m * h * d)
                          * q.element_size())
                bms, by = bound(nbytes, 4 * b * h * n * m * d, dtype)
                line += (f' ms={ms:.4f} plain_ms={plain_ms:.4f} '
                         f'sdpa_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}); '
                         f'{CARD}')
                if label == 'stage-2 self' and dtype == torch.bfloat16:
                    entry = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by, library_ms=lib_ms)
            log(line)
            del q, k, v, out, out2, lse, ref, err, want_lse
    return entry


def check_k4(g):
    """K4 against ``flash_attention_backward_plain`` at the training path's
    shapes: stage-2 self (B = 8, N = M = 1024, H = 16) and cross (M = 77)
    attention in fp32 and bf16, and a ragged case (N = 200, M = 77).  Gates:
    mean relative error per gradient <= 1e-5 in fp32 (measured on an H100:
    4e-7) and <= 1e-3 in bf16 (measured 7e-6).  The plain version rounds P
    and dS to bf16 before the products that consume them, as the kernel
    does, so what is left in bf16 is where the two differ in fp32 before a
    rounding (the order of the sums, the hardware's exp2, lse from K1
    against an exact softmax), which now and then moves a P, a dS or a
    gradient by one bf16 step.  Against the tiled emulation, which also
    shares the kernel's lse: <= 1e-4 (measured 4e-6).
    ``torch.autograd.grad`` through ``flash_attention`` must give the bits
    of a direct K4 call, and a second direct call the same bits again.
    Times the training shapes (``ATTN_CASES``: stage-2 and VQGAN at head dim
    64, VQGAN at 128 and 32; the ragged cases checked only); the result line
    carries the stage-2 path's most frequent call, stage-2 self-attention in
    bf16, beside the backward of ``F.scaled_dot_product_attention`` on a
    retained graph."""
    entry = None
    for label, b, n, m, h, d, timed in ATTN_CASES:
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, go = (torch.randn(b, rows, h, d, device='cuda',
                                       generator=g).to(dtype)
                           for rows in (n, m, m, n))
            lse = fa._launch_forward(q, k, v, scale, with_lse=True)[1]
            got = fa.flash_attention_backward(q, k, v, go, scale, lse)
            ref = fa.flash_attention_backward_plain(q, k, v, go, scale)
            torch.cuda.synchronize()
            errs = [mean_rel(a, r) for a, r in zip(got, ref)]
            max_abs = max((a.float() - r.float()).abs().max().item()
                          for a, r in zip(got, ref))
            gate = 1e-5 if dtype == torch.float32 else 1e-3
            check(max(errs) <= gate and all(torch.isfinite(a).all() for a in got),
                  f'K4 {label} {dtype}: mean rel err dq, dk, dv {errs}')
            again = fa.flash_attention_backward(q, k, v, go, scale, lse)
            check(all(torch.equal(a, r) for a, r in zip(again, got)),
                  f'K4 {label} {dtype}: two calls differ')
            tiled = ''
            if dtype == torch.bfloat16:
                emu = fa.flash_attention_backward_tiled(q, k, v, go, scale, lse)
                emu_err = max(mean_rel(a, r) for a, r in zip(got, emu))
                check(emu_err <= 1e-4, f'K4 {label} bf16 against the tiled '
                      f'emulation: mean rel err {emu_err}')
                tiled = f' vs_tiled_mean_rel={emu_err:.3e}'
                del emu
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o2 = fa.flash_attention(*leaves, scale)
            check(o2.grad_fn is not None, 'flash_attention result is detached')
            auto = torch.autograd.grad(o2, leaves, go)
            check(all(torch.equal(a, r) for a, r in zip(auto, got)),
                  f'K4 {label} {dtype}: autograd.grad differs from a direct call')
            line = (f'K4 {label} B={b} N={n} M={m} H={h} D={d} {str(dtype)[6:]}: '
                    f'mean_rel_err dq={errs[0]:.3e} dk={errs[1]:.3e} '
                    f'dv={errs[2]:.3e} max_abs_err={max_abs:.3e}{tiled}')
            if timed:
                ms = time_ms(lambda: fa.flash_attention_backward(
                    q, k, v, go, scale, lse), 10)
                plain_ms = time_ms(lambda: fa.flash_attention_backward_plain(
                    q, k, v, go, scale), 3)
                lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True)
                              for t in (q, k, v))
                lo = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
                lg = go.transpose(1, 2)
                lib_ms = time_ms(lambda: torch.autograd.grad(
                    lo, (lq, lk, lv), lg, retain_graph=True), 10)
                # q, k, v, g and the log-sum-exp read once, dq, dk, dv
                # written once; five products
                nbytes = ((3 * b * n * h * d + 4 * b * m * h * d)
                          * q.element_size() + lse.numel() * 4)
                bms, by = bound(nbytes, 10 * b * h * n * m * d, dtype)
                line += (f' ms={ms:.4f} plain_ms={plain_ms:.4f} '
                         f'sdpa_bwd_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}); '
                         f'{CARD}')
                if label == 'stage-2 self' and dtype == torch.bfloat16:
                    entry = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by, library_ms=lib_ms)
                del lq, lk, lv, lo, lg
            log(line)
            del q, k, v, go, lse, got, again, ref, leaves, o2, auto
    return entry


def k2_compare(z, e, what):
    """K2 against ``nearest_codes_plain``: equal but for near-ties (score
    gap < 1e-5); a second launch gives the same bits.  Returns (kernel's
    indices, how many differ, the largest gap)."""
    got = vq.fused_nearest_codes(z, e)
    again = vq.fused_nearest_codes(z, e)
    ref = vq.nearest_codes_plain(z, e)
    check(torch.equal(got, again), f'K2 {what}: two launches differ')
    check(bool(((got >= 0) & (got < e.shape[0])).all()),
          f'K2 {what}: an index outside the codebook')
    scores = z @ e.t()
    rows = torch.arange(z.shape[0], device='cuda')
    gap = (scores[rows, got.long()] - scores[rows, ref.long()]).abs()
    differ, max_gap = int((got != ref).sum()), gap.max().item()
    check(max_gap < 1e-5, f'K2 {what} disagrees beyond a near-tie: gap {max_gap}')
    return got, differ, max_gap


def check_k2(g):
    """T = 8·1024 l2-normalised queries against the shipped 8192 x 32
    codebook.  Indices equal, except at near-ties (score gap < 1e-5); the
    same at ragged sizes (T = 1000, C = 1000), at T = 1024 (one image batch
    of the serving engine at B = 1: the codebook split over 16 blocks per
    token tile) and at T = 1; on a codebook whose upper half repeats its
    lower half every index lies in the lower half (exact ties go to the
    lowest index through every merge and split).  Other code dims (C3): 8
    (compiled), 16 (compiled), 12 (zero-padded to 16), 48 (padded to 64, one
    chunk of the chunked variant) and 100 (padded to 128, two chunks), each
    on a seeded 8192-row codebook at T = 8192 and T = 1000 (ragged), the
    same gate.  Two launches bit-equal everywhere.  Times T = 8192 at code
    dims 32 and 8 (beside the plain version and ``argmax(z @ eᵀ)``), and
    T = 1024."""
    codebook = load_flat(ASSET)['quantize/codebook'].float().cuda()
    e = tq.l2norm(codebook).contiguous()
    z = tq.l2norm(torch.randn(8 * 1024, 32, device='cuda', generator=g))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, differ, max_gap = k2_compare(z, e, 'T=8192')
    notes = []
    for what, zz, ee in (('T=1000 C=1000', z[:1000], e[:1000].contiguous()),
                         ('T=1024', z[:1024], e), ('T=1', z[:1], e)):
        _, d, gap = k2_compare(zz, ee, what)
        splits = vq.codebook_splits(zz.shape[0], ee.shape[0], sms)
        notes.append(f'{what} ({splits} splits): {d} differ, gap {gap:.1e}')
    half = e.shape[0] // 2
    dup = torch.cat([e[:half], e[:half]]).contiguous()
    for what, zz in (('duplicated codebook T=8192', z),
                     ('duplicated codebook T=1024', z[:1024])):
        got, d, gap = k2_compare(zz, dup, what)
        check(bool((got < half).all()), f'K2 {what}: an exact tie went to the '
              'higher index')
        notes.append(f'{what}: all in the lower half, {d} differ, gap {gap:.1e}')
    log('K2 ' + '; '.join(notes))
    notes = []
    for dim in (8, 16, 12, 48, 100):
        ed = tq.l2norm(torch.randn(8192, dim, device='cuda', generator=g))
        zd = tq.l2norm(torch.randn(8 * 1024, dim, device='cuda', generator=g))
        for what, zz in ((f'D={dim} T=8192', zd), (f'D={dim} T=1000', zd[:1000])):
            _, d, gap = k2_compare(zz, ed, what)
            notes.append(f'{what} (kernel dim {vq.kernel_code_dim(dim)}): '
                         f'{d} differ, gap {gap:.1e}')
        if dim == 8:
            ms8 = time_ms(lambda: vq.fused_nearest_codes(zd, ed), 50)
            plain8 = time_ms(lambda: vq.nearest_codes_plain(zd, ed), 20)
            lib8 = time_ms(lambda: torch.argmax(zd @ ed.t(), dim=-1), 20)
            bms8, _ = bound((2 * 8192 * 8) * 4 + 8192 * 4, 2 * 8192 * 8192 * 8,
                            torch.float32)
            notes.append(f'D=8 T=8192 ms={ms8:.4f} plain_ms={plain8:.4f} '
                         f'argmax_matmul_ms={lib8:.4f} bound_ms={bms8:.4f}')
    log('K2 code dims: ' + '; '.join(notes) + f'; {CARD}')
    t, c, d = z.shape[0], e.shape[0], z.shape[1]
    ms = time_ms(lambda: vq.fused_nearest_codes(z, e), 50)
    plain_ms = time_ms(lambda: vq.nearest_codes_plain(z, e), 20)
    lib_ms = time_ms(lambda: torch.argmax(z @ e.t(), dim=-1), 20)
    z1 = z[:1024]
    ms1 = time_ms(lambda: vq.fused_nearest_codes(z1, e), 50)
    lib_ms1 = time_ms(lambda: torch.argmax(z1 @ e.t(), dim=-1), 20)
    bms, by = bound((t * d + c * d) * 4 + t * 4, 2 * t * c * d, torch.float32)
    bms1, _ = bound((1024 * d + c * d) * 4 + 1024 * 4, 2 * 1024 * c * d,
                    torch.float32)
    log(f'K2 T={t} C={c} D={d} fp32 ({vq.codebook_splits(t, c, sms)} splits): '
        f'{differ} of {t} ids differ (max score gap {max_gap:.3e}) '
        f'ms={ms:.4f} = {2 * t * c * d / ms / 1e9:.2f} TFLOP/s '
        f'plain_ms={plain_ms:.4f} argmax_matmul_ms={lib_ms:.4f} '
        f'bound_ms={bms:.4f} ({by}); T=1024: ms={ms1:.4f} = '
        f'{2 * 1024 * c * d / ms1 / 1e9:.2f} TFLOP/s '
        f'argmax_matmul_ms={lib_ms1:.4f} bound_ms={bms1:.4f}; {CARD}')
    return dict(max_abs_err=max_gap, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


# operations per logit that the sampling function cannot avoid, whatever
# the algorithm: the row max (1), exp(l - max) and its sum (3), and one
# compare for the top-k selection (1).  The noise, the temperature and the
# argmax touch only the k survivors, and conf is one exp per row.
K3_OPS_PER_LOGIT = 5


def k3_with_seed(logits, temperature, k, g):
    """One K3 launch, and the seed it drew from ``g``."""
    state = g.get_state()
    seed = sm.draw_seed(g, 'cuda')
    g.set_state(state)
    pred, conf = sm.fused_gumbel_topk_sample(logits, temperature, k, generator=g)
    return pred, conf, seed


def k3_against_plain(logits, temperature, k, g, what, near_tie=1e-5):
    """K3 against ``gumbel_topk_sample_plain`` on the noise the launch drew
    (``philox_gumbel`` of its seed): pred equal except on rows whose two
    best perturbed scores lie within ``near_tie`` (``logf`` on the card and
    in PyTorch differ in the last bits), conf within 1e-5 on the equal
    rows.  Returns (rows that differ, max conf error)."""
    pred, conf, seed = k3_with_seed(logits, temperature, k, g)
    noise = sm.philox_gumbel(seed, logits.shape, device='cuda')
    rpred, rconf = sm.gumbel_topk_sample_plain(logits, temperature, k, noise)
    l = logits.float()
    shape = l.shape[:-1]
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device='cuda').clamp(min=1e-10)
    if temp.ndim:  # per-sample (B,)
        temp = temp.reshape(-1, *([1] * (l.ndim - 1)))
    score = torch.where(sm.topk_keep_mask(l, k), l / temp + noise, -torch.inf)
    del noise
    top2 = score.topk(min(2, k), dim=-1).values
    gap = (top2[..., 0] - top2[..., -1]).abs() if k > 1 else \
        torch.full(shape, torch.inf, device='cuda')
    same = pred == rpred
    check(bool((same | (gap < near_tie)).all()),
          f'K3 {what}: pred differs from the plain version on the same noise '
          f'beyond a near-tie ({int((~same).sum())} rows differ)')
    err = ((conf - rconf).abs() * same).max().item()
    check(err <= 1e-5, f'K3 {what}: conf err {err}')
    return int((~same).sum()), err


def check_k3(g):
    """(8·1024, 8192) logits, top-k 5.  Temperature 1e-10 on distinct fp32
    logits: pred equal to the plain version, conf within 1e-6.  Temperature
    1: pred in the exact top-5 set, conf = softmax(logits)[pred] within
    1e-5 (fp32 and bf16 logits), and over 8192 draws of one row the
    frequencies match the top-5 softmax within 0.02.  Against the plain
    version on the kernel's own noise (``k3_against_plain``) at temperature
    1, 0.7 and per-sample, fp32 and bf16; at a ragged size (T = 37, V = 500,
    k = 3, rows off the 16-byte grid) and on mass ties (integer logits) at
    temperature 1e-10 and 1, k = 1, 3, 16.  One seed twice: the same bits;
    two seeds: different.  Times bf16 and fp32 at 8192 x 8192 and bf16 at
    1024 x 8192 (B = 1; 16.8 MB, which the 50 MB L2 can hold between the
    timed launches)."""
    t, v, k = 8 * 1024, 8192, 5
    # distinct values in every row: a seeded permutation of an even grid
    grid = torch.arange(v, device='cuda', dtype=torch.float32) * (8.0 / v) - 4
    logits = grid[torch.rand(t, v, device='cuda', generator=g).argsort(-1)]
    pred, conf = sm.fused_gumbel_topk_sample(logits, 1e-10, k, generator=g)
    noise = sm.gumbel_noise(logits.shape, generator=g, device='cuda')
    rpred, rconf = sm.gumbel_topk_sample_plain(logits, 1e-10, k, noise)
    check(torch.equal(pred, rpred), 'K3 pred differs at temperature 1e-10')
    conf_err = (conf - rconf).abs().max().item()
    check(conf_err <= 1e-6, f'K3 conf err {conf_err} at temperature 1e-10')

    for dtype in (torch.float32, torch.bfloat16):
        lg = logits.to(dtype)
        pred, conf = sm.fused_gumbel_topk_sample(lg, 1.0, k, generator=g)
        keep = sm.topk_keep_mask(lg.float(), k)
        check(bool(keep.gather(1, pred.long()[:, None]).all()),
              f'K3 {dtype} sampled outside the top-{k}')
        want = torch.softmax(lg.float(), -1).gather(1, pred.long()[:, None])[:, 0]
        err = (conf - want).abs().max().item()
        check(err <= 1e-5, f'K3 {dtype} conf err {err}')
        del keep, want

    row = torch.randn(v, device='cuda', generator=g) - 8
    row[[11, 900, 4000, 6001, 8191]] = torch.tensor(
        [2.0, 1.5, 1.0, 0.5, 0.0], device='cuda')
    draws = row.expand(8192, v).contiguous()
    pred, _ = sm.fused_gumbel_topk_sample(draws, 1.0, k, generator=g)
    top = torch.tensor([11, 900, 4000, 6001, 8191], device='cuda')
    freq = (pred[:, None] == top[None, :]).float().mean(0)
    want = torch.softmax(row[top], 0)
    dist_err = (freq - want).abs().max().item()
    check(bool((pred[:, None] == top[None, :]).any(1).all()),
          'K3 drew outside the top-5 of the repeated row')
    check(dist_err <= 0.02, f'K3 frequencies off the top-5 softmax by {dist_err}')
    del draws

    # sample for sample against the plain version on the kernel's own noise
    near, plain_err = 0, 0.0
    wide = (torch.randn(8, 1024, v, device='cuda', generator=g) * 3)
    per_sample = torch.linspace(0.3, 2.0, 8, device='cuda')
    for dtype in (torch.float32, torch.bfloat16):
        lg = wide.to(dtype)
        for temp in (1.0, 0.7, per_sample):
            n, err = k3_against_plain(lg, temp, k, g, f'{dtype} temp {temp}')
            near, plain_err = near + n, max(plain_err, err)
    del wide, lg
    small = 0
    ties = torch.randint(0, 4, (37, 500), device='cuda', generator=g).float()
    ragged = torch.randn(37, 500, device='cuda', generator=g) * 3
    for name, lg in (('mass ties', ties), ('ragged', ragged)):
        for dtype in (torch.float32, torch.bfloat16):
            for kk in (1, 3, 16):
                for temp in (1e-10, 1.0):
                    # one element off the 16-byte grid: every row has a head
                    off = torch.empty(lg.numel() + 1, device='cuda', dtype=dtype)
                    for view in (lg.to(dtype), off[1:].view_as(lg).copy_(lg)):
                        n, err = k3_against_plain(
                            view, temp, kk, g, f'{name} {dtype} k={kk} temp {temp}',
                            near_tie=1e-5 if temp == 1.0 else 0.0)
                        small, plain_err = small + n, max(plain_err, err)

    lb = logits.to(torch.bfloat16)  # the pipeline's logits type
    state = g.get_state()
    first = sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g)
    g.set_state(state)
    second = sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g)
    other = sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g)
    check(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
          'K3: one seed, two launches, different bits')
    check(not torch.equal(first[0], other[0]), 'K3: two seeds, the same sample')

    noise = noise.to(torch.bfloat16)
    ms = time_ms(lambda: sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g), 50)
    plain_ms = time_ms(lambda: sm.gumbel_topk_sample_plain(lb, 1.0, k, noise), 5)
    del noise
    ms32 = time_ms(lambda: sm.fused_gumbel_topk_sample(logits, 1.0, k,
                                                       generator=g), 50)
    one = lb[:1024].contiguous()
    ms1 = time_ms(lambda: sm.fused_gumbel_topk_sample(one, 1.0, k, generator=g), 50)

    def k3_bound(rows, size):
        return bound(rows * v * size + 8 + rows * (4 + 4),
                     rows * v * K3_OPS_PER_LOGIT, torch.float32)

    bms, by = k3_bound(t, 2)
    log(f'K3 T={t} V={v} k={k}: temp 1e-10 conf_err={conf_err:.3e}; temp 1 '
        f'top-5 softmax frequency err={dist_err:.4f} over 8192 draws; against '
        f'the plain version on the kernel\'s own noise: {near} of {6 * t} rows '
        f'differ at near-ties (< 1e-5), {small} of the small ragged / '
        f'mass-tie rows, conf err {plain_err:.3e}; bf16 ms={ms:.4f} = '
        f'{t * v * 2 / ms / 1e6:.0f} GB/s plain_ms={plain_ms:.4f} (noise given) '
        f'bound_ms={bms:.4f} ({by}); fp32 ms={ms32:.4f} = '
        f'{t * v * 4 / ms32 / 1e6:.0f} GB/s bound_ms={k3_bound(t, 4)[0]:.4f}; '
        f'bf16 T=1024 ms={ms1:.4f} = {1024 * v * 2 / ms1 / 1e6:.0f} GB/s '
        f'bound_ms={k3_bound(1024, 2)[0]:.4f}; {CARD}')
    return dict(max_abs_err=max(conf_err, plain_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)


def check_k3_radix(g):
    """K3's k > 16 kernel (one block a row, radix select) against the plain
    version sample for sample on its own Philox noise (``k3_against_plain``)
    for k = 17, 32, 100 and V: ragged rows (T = 37, V = 500, also one
    element off the 16-byte grid), mass ties (integer logits) and rows of
    +0 / -0, fp32 and bf16, temperature 1e-10 (no near-tie allowed) and 1; a
    row of 20000 classes (keys in more than 48 KB of shared memory) and one
    of 60000 (too long for shared memory: every pass reads the row again);
    the main path's shape (8·1024, 8192) at k = 32 at temperature 1 and per
    sample.  One seed twice: the same bits.  Times bf16 8192 x 8192 at
    k = 32 beside its bound (one read of the logits, as for K3) and the
    plain version."""
    near, small, plain_err = 0, 0, 0.0
    ties = torch.randint(0, 4, (37, 500), device='cuda', generator=g).float()
    ragged = torch.randn(37, 500, device='cuda', generator=g) * 3
    zeros = torch.where(torch.rand(37, 500, device='cuda', generator=g) < 0.5,
                        0.0, -0.0)
    for name, lg in (('mass ties', ties), ('ragged', ragged), ('+-0', zeros)):
        for dtype in (torch.float32, torch.bfloat16):
            for kk in (17, 32, 100, 500):
                for temp in (1e-10, 1.0):
                    off = torch.empty(lg.numel() + 1, device='cuda', dtype=dtype)
                    for view in (lg.to(dtype), off[1:].view_as(lg).copy_(lg)):
                        n, err = k3_against_plain(
                            view, temp, kk, g, f'{name} {dtype} k={kk} temp {temp}',
                            near_tie=1e-5 if temp == 1.0 else 0.0)
                        small, plain_err = small + n, max(plain_err, err)
    for t, v, kk in ((16, 20000, 64), (4, 60000, 17), (4, 60000, 1000)):
        lg = torch.randn(t, v, device='cuda', generator=g) * 3
        n, err = k3_against_plain(lg, 1.0, kk, g, f'T={t} V={v} k={kk}')
        small, plain_err = small + n, max(plain_err, err)
    t, v, k = 8 * 1024, 8192, 32
    wide = torch.randn(8, 1024, v, device='cuda', generator=g) * 3
    per_sample = torch.linspace(0.3, 2.0, 8, device='cuda')
    for dtype in (torch.bfloat16, torch.float32):
        lg = wide.to(dtype)
        for temp in (1.0, per_sample):
            n, err = k3_against_plain(lg, temp, k, g, f'{dtype} k={k} temp {temp}')
            near, plain_err = near + n, max(plain_err, err)
    lb = wide.reshape(t, v).to(torch.bfloat16)
    del wide, lg
    state = g.get_state()
    first = sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g)
    g.set_state(state)
    second = sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g)
    check(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
          'K3r: one seed, two launches, different bits')
    keep = sm.topk_keep_mask(lb.float(), k)
    check(bool(keep.gather(1, first[0].long()[:, None]).all()),
          f'K3r sampled outside the top-{k}')
    del keep
    noise = sm.gumbel_noise(lb.shape, generator=g, device='cuda')
    ms = time_ms(lambda: sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g), 50)
    plain_ms = time_ms(lambda: sm.gumbel_topk_sample_plain(lb, 1.0, k, noise), 2)
    del noise
    bms, by = bound(t * v * 2 + 8 + t * (4 + 4), t * v * K3_OPS_PER_LOGIT,
                    torch.float32)
    log(f'K3r (k > 16) T={t} V={v} k={k}: against the plain version on the '
        f"kernel's own noise: {near} of {4 * t} rows differ at near-ties "
        f'(< 1e-5), {small} of the small ragged / mass-tie / +-0 / long rows, '
        f'conf err {plain_err:.3e}; bf16 ms={ms:.4f} = '
        f'{t * v * 2 / ms / 1e6:.0f} GB/s plain_ms={plain_ms:.4f} (noise '
        f'given) bound_ms={bms:.4f} ({by}); {CARD}')
    return dict(max_abs_err=plain_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def seeded_images(b, size, seed):
    """Smooth seeded images in [-1, 1], NHWC."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    low = torch.rand(b, 3, 16, 16, device='cuda', generator=g) * 2 - 1
    img = F.interpolate(low, size=(size, size), mode='bicubic',
                        align_corners=False).clamp(-1, 1)
    return img.permute(0, 2, 3, 1).contiguous()


def drive(fn, expected, totals, what):
    """Run one main-path call with the counters at 0; check and add them
    (a kernel that ``expected`` does not name must not launch)."""
    expected = {name: expected.get(name, 0) for name in KERNEL_COUNTERS}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check(counts == expected, f'{what}: launches {counts}, expected {expected}')
    for name, n in counts.items():
        totals[name] += n
    log(f'{what}: {seconds:.3f} s, launches {counts}')
    return out, seconds


def stage1(totals):
    vqgan = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=ASSET)
    x = seeded_images(8, 256, 1)
    enc, dec = vqgan.config.enc.depth, vqgan.config.dec.depth
    rec, _ = drive(lambda: vqgan.reconstruct(x),
                   {'K1': enc + dec, 'K2': 1, 'K3': 0, 'K4': 0}, totals,
                   'stage 1 reconstruct B=8 256² fp32')
    _, _, ids = vqgan.encode(x)
    plain = vqgan.reconstruct(x, backend='plain', vq_backend='plain')
    _, _, plain_ids = vqgan.encode(x, backend='plain', vq_backend='plain')
    mae = (rec - plain).abs().mean().item()
    agree = (ids == plain_ids).float().mean().item()
    check(torch.isfinite(rec).all() and rec.shape == (8, 256, 256, 3),
          'stage 1 output')
    check(agree >= 0.999 and mae <= 1e-3,
          f'stage 1 kernel vs plain: ids agree {agree}, MAE {mae}')
    ms = median_ms(lambda: vqgan.reconstruct(x), 5)
    pil = Image.fromarray(((x[0].cpu().numpy() + 1) * 127.5).astype(np.uint8))
    fig, _ = drive(lambda: pt.reconstruction(pil, model=vqgan),
                   {'K1': enc + dec, 'K2': 1, 'K3': 0, 'K4': 0}, totals,
                   'stage 1 reconstruction demo (PIL in, figure out)')
    check(fig.size == (512, 256), f'reconstruction figure {fig.size}')
    psnr = 10 * np.log10(4.0 / ((rec - x) ** 2).mean().item())
    log(f'stage 1: kernel vs plain MAE={mae:.3e}, ids agree {agree:.5f}, '
        f'{ms:.3f} ms per call = {8e3 / ms:.2f} images/s (median of 5 '
        f'CUDA-event timed calls after a warm-up), PSNR vs input {psnr:.2f} dB')


def check_images(imgs, what):
    check(imgs.shape == (8, 256, 256, 3), f'{what} shape {tuple(imgs.shape)}')
    check(bool(torch.isfinite(imgs).all()), f'{what} not finite')
    check(float(imgs.abs().max()) <= 1.0, f'{what} outside [-1, 1]')


def stage2(totals):
    pipe = pt.create_model('pipeline', 'paintmindv1', pretrained=False,
                           stage1_checkpoint_path=ASSET, text_encoder=None,
                           compute_dtype=torch.bfloat16)
    cfg = pipe.config
    log(f'stage 2: paintmindv1 dim={cfg.dim} depth={cfg.depth} '
        f'heads={cfg.num_head} vocab={cfg.vqc.n_embed}, '
        f'{pipe.num_params / 1e6:.1f} M parameters (bf16)')
    g = torch.Generator(device='cuda').manual_seed(0)
    ctx = torch.randn(8, 77, cfg.t5_dim, device='cuda', generator=g)
    steps, depth, dec = 16, cfg.depth, cfg.vqc.dec.depth
    torch.cuda.reset_peak_memory_stats()
    pipe.generate(text=ctx, timesteps=2, topk=5, decode_steps='final',
                  generator=g)  # warm-up: cuBLAS handles, allocator

    def gen(**kw):
        return pipe.generate(text=ctx, timesteps=steps, topk=5,
                             decode_steps='final', generator=g, **kw)[-1]

    imgs, s_plain = drive(gen, {'K1': depth * 2 * steps + dec, 'K2': 0,
                                'K3': steps, 'K4': 0}, totals,
                          'generate B=8 16 steps')
    check_images(imgs, 'generate')
    guided, s_cfg = drive(lambda: gen(guidance_scale=3.0),
                          {'K1': depth * 3 * steps + dec, 'K2': 0,
                           'K3': steps, 'K4': 0}, totals,
                          'generate B=8 16 steps guidance_scale=3.0')
    check_images(guided, 'guided generate')
    paint_steps = 4
    painted, _ = drive(lambda: pipe.inpaint(imgs, (64, 64, 128, 128), text=ctx,
                                            timesteps=paint_steps,
                                            generator=g),
                       {'K1': cfg.vqc.enc.depth + depth * 2 * paint_steps + dec,
                        'K2': 1, 'K3': paint_steps, 'K4': 0}, totals,
                       'inpaint B=8 4 steps')
    check_images(painted, 'inpaint')
    log(f'stage 2: {8 / s_plain:.3f} images/s without guidance, '
        f'{8 / s_cfg:.3f} images/s with guidance (B=8, 16 steps, incl. decode)')

    # the logits of one step through the kernels and through the plain
    # attention agree to bf16 rounding
    _, _, ids = pipe.vqgan.encode(imgs)
    ids[:, ::3] = cfg.mask_token_id
    tokens = ids_to_tokens(pipe, ids, cfg)
    with torch.no_grad():
        lk = _transformer_logits(pipe, tokens, ctx, 3.0, cfg=cfg,
                                 dtype=torch.bfloat16).float()
        lp = _transformer_logits(pipe, tokens, ctx, 3.0, cfg=cfg,
                                 dtype=torch.bfloat16, backend='plain').float()
    rel = ((lk - lp).abs().mean() / lp.abs().mean()).item()
    top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    check(rel <= 5e-2, f'stage-2 logits kernel vs plain: mean rel err {rel}')
    log(f'stage 2 guided logits, kernels vs plain attention: mean rel err '
        f'{rel:.3e}, argmax agree {top1:.4f}')
    log(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    return pipe


# ---------------------------------------------------------------------------
# phase 6: the serving path (engine, HTTP server, T5 and CLIP towers)
# ---------------------------------------------------------------------------

def hash_tokenizer(texts, truncation=True, max_length=77,
                   padding='max_length', return_tensors='np'):
    """A deterministic stand-in for the flan-t5 tokenizer (no vocabulary is
    in the repository): each word hashed to an id below 32000, then the
    end-of-text id 1, padded with 0 to ``max_length``."""
    ids = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        words = [2 + int.from_bytes(hashlib.blake2s(
            w.encode(), digest_size=4).digest(), 'little') % 31998
            for w in text.lower().split()]
        words = (words + [1])[:max_length]
        ids[i, :len(words)] = words
    return {'input_ids': ids}


def record_batches(pipe, calls):
    """Wrap the entry points the engine calls once per batch, so that each
    batch is recorded as (kind, steps, top-k, guided, batch size, start,
    end): host clock, the end after a synchronise (the engine synchronises
    there anyway, moving the images to the host)."""
    generate, paint, reconstruct = pipe.generate, pipe.paint, pipe.vqgan.reconstruct

    def guided(kw):
        return kw.get('guidance_scale') is not None and kw.get('text') is not None

    def timed(what, run, size):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        calls.append(what + (size, t0, time.perf_counter()))
        return out

    def gen(**kw):
        size = kw['num_samples'] if kw.get('text') is None else len(kw['text'])
        return timed(('generate', kw['timesteps'], kw['topk'], guided(kw)),
                     lambda: generate(**kw), size)

    def pnt(img, keep, **kw):
        return timed(('paint', kw['timesteps'], kw['topk'], guided(kw)),
                     lambda: paint(img, keep, **kw), len(img))

    def rec(img):
        return timed(('reconstruct', 0, 0, False), lambda: reconstruct(img),
                     len(img))

    pipe.generate, pipe.paint, pipe.vqgan.reconstruct = gen, pnt, rec


def expected_launches(calls, cfg):
    """Kernel launches of the recorded batches: per sampler step K3 once
    (K3r for top-k > 16) and K1 once per attention of each of the depth
    layers (self + cross, and the unconditional half's self-attending cross
    layer with guidance), the decoder's K1 per batch; an encode (paint,
    reconstruct) adds the encoder's K1 and one K2."""
    depth, enc, dec = cfg.depth, cfg.vqc.enc.depth, cfg.vqc.dec.depth
    want = dict.fromkeys(KERNEL_COUNTERS, 0)
    for kind, steps, topk, guided, *_ in calls:
        want['K1'] += dec
        if kind in ('paint', 'reconstruct'):
            want['K1'] += enc
            want['K2'] += 1
        if kind != 'reconstruct':
            want['K3' if topk <= sm.MAX_K else 'K3r'] += steps
            want['K1'] += depth * (3 if guided else 2) * steps
    return want


def post(port, path, body):
    """One JSON request to the local server (no proxy); (status, reply,
    seconds)."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    try:
        with opener.open(req, timeout=600) as resp:
            status, out = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        status, out = e.code, json.loads(e.read())
    return status, out, time.perf_counter() - t0


def png_size(b64):
    with Image.open(io.BytesIO(base64.b64decode(b64))) as im:
        return im.size


def png_b64(img):
    arr = ((img.float().cpu().numpy() + 1) * 127.5).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


class Served:
    """An engine behind ``make_server`` on an ephemeral port, served from a
    thread; closed (server, then engine) on exit."""

    def __init__(self, pipe, **kw):
        self.engine = GenerationEngine(pipe, **kw)
        self.httpd = make_server(self.engine, '127.0.0.1', 0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(60)
        self.engine.close(timeout=600)


def serving_phase(totals):
    """``make_server`` over a ``GenerationEngine`` (max_batch 8) over a
    full-width bf16 ``paintmindv1`` pipeline (seeded random stage 2, the
    shipped stage 1) with a full-width flan-t5-large ``T5TextEncoder``
    (24 layers, d_model 1024, seeded random weights, fp32) and the stand-in
    tokenizer.  One concurrent burst over HTTP: 16 prompted /generate (16
    steps, top-k 5, half seeded), 8 with mixed guidance, 2 with top-k 32
    (K3r), 4 /reconstruct, 2 /inpaint + 2 /outpaint with different rects,
    one malformed coord.  Gates: 400 for the malformed one, 200 and a 256²
    PNG for every other; errors 0; batches coalesce (mean occupancy > 1);
    the launches equal those of the batches the engine ran (K3 + K3r = the
    sum of the sampler steps; K2 one per reconstruct and paint batch; no
    K4).  Eight identical seeded requests, twice as one batch: bit-equal
    images.  Then /variations (``paintmindv1-imgvar``, full-width ViT-L/14
    ``CLIPImageEmbedder``, num 4) and the text pipeline's 400 there."""
    from paintmind_tpu_torch.models import clip as tclip
    from paintmind_tpu_torch.models import t5 as tt5
    t5 = tt5.T5TextEncoder(
        model=tt5.T5Encoder(tt5.T5Config.flan_t5_large(), device='cuda', seed=11),
        tokenizer=hash_tokenizer, device='cuda')
    pipe = pt.create_model('pipeline', 'paintmindv1', pretrained=False,
                           stage1_checkpoint_path=ASSET, text_encoder=t5,
                           compute_dtype=torch.bfloat16)
    cfg = pipe.config
    n_t5 = sum(p.numel() for p in t5.model.parameters())
    log(f'serving: paintmindv1 bf16 + flan-t5-large encoder ({n_t5 / 1e6:.1f} M '
        f'parameters, fp32, seeded random), max_batch 8')
    g = torch.Generator(device='cuda').manual_seed(5)
    imgs = seeded_images(8, 256, 9)
    calls = []
    record_batches(pipe, calls)
    with Served(pipe, max_batch=8, max_wait_ms=100) as srv:
        port, eng = srv.port, srv.engine
        # warm-up: cuBLAS handles, the allocator, the tower's first call
        status, _, _ = post(port, '/generate', {'prompt': 'warm up',
                                                'timesteps': 2, 'topk': 5})
        check(status == 200, f'warm-up /generate: {status}')
        eng.reset_stats()
        calls.clear()

        jobs = []
        for i in range(16):
            body = {'prompt': f'a painting of a red fox number {i}',
                    'timesteps': 16, 'topk': 5}
            if i % 2 == 0:
                body['seed'] = 100 + i
            jobs.append(('/generate', body))
        for i in range(8):
            jobs.append(('/generate', {'prompt': f'a guided lighthouse {i}',
                                       'timesteps': 16, 'topk': 5,
                                       'guidance_scale': 1.5 + 0.5 * i,
                                       'seed': 200 + i}))
        for i in range(2):
            jobs.append(('/generate', {'prompt': f'a wide sample {i}',
                                       'timesteps': 16, 'topk': 32}))
        for i in range(4):
            jobs.append(('/reconstruct', {'image': png_b64(imgs[i])}))
        for i, (path, rect) in enumerate((
                ('/inpaint', [64, 64, 128, 128]), ('/inpaint', [0, 0, 96, 160]),
                ('/outpaint', [32, 32, 192, 192]), ('/outpaint', [96, 0, 128, 64]))):
            jobs.append((path, {'image': png_b64(imgs[4 + i]), 'coord': rect,
                                'prompt': f'a paint prompt {i}',
                                'timesteps': 8, 'seed': 300 + i}))
        jobs.append(('/inpaint', {'image': png_b64(imgs[0]),
                                  'coord': [0, 0, 999, 999]}))
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as pool:
            replies = list(pool.map(lambda job: post(port, *job), jobs))
        burst_s = time.perf_counter() - t0
        counts = read_counts()
        stats = eng.stats()
        want = expected_launches(calls, cfg)
        for (path, body), (status, out, _) in zip(jobs, replies):
            if body.get('coord') == [0, 0, 999, 999]:
                check(status == 400 and 'outside' in out['error'],
                      f'malformed coord: {status} {out}')
            else:
                check(status == 200 and png_size(out['image']) == (256, 256),
                      f'{path}: {status} {str(out)[:200]}')
        check(stats['errors'] == 0, f'engine errors: {stats}')
        check(stats['mean_batch_occupancy'] > 1, f'no coalescing: {stats}')
        check(counts == want, f'serving burst: launches {counts}, the '
              f'{len(calls)} batches {calls} need {want}')
        check(counts['K4'] == 0 and counts['K3r'] > 0, f'launches {counts}')
        for name, n in counts.items():
            totals[name] += n
        gen_lat = sorted(r[2] for (path, _), r in zip(jobs, replies)
                         if path == '/generate')
        log(f'serving burst: {len(jobs)} requests ({len(gen_lat)} /generate) in '
            f'{burst_s:.3f} s = {len(gen_lat) / burst_s:.3f} /generate requests/s '
            f'({len(jobs) / burst_s:.3f} requests/s of all kinds); engine '
            f'latency_p50_s={stats["latency_p50_s"]:.3f} '
            f'latency_p95_s={stats["latency_p95_s"]:.3f} (queue + batch); '
            f'client /generate p50 {gen_lat[len(gen_lat) // 2]:.3f} s, max '
            f'{gen_lat[-1]:.3f} s (HTTP and T5 included); {stats["batches"]} '
            f'batches, mean occupancy {stats["mean_batch_occupancy"]:.2f}, '
            f'padded slots {stats["padded_slots"]}; launches {counts}; {CARD}')
        busy = sum(c[6] - c[5] for c in calls)
        log(f'serving batches (kind steps/top-k, g = guided, B = bucket, start '
            f'and end after the burst began, s): '
            + '; '.join(f'{c[0][0]}{c[1]}/{c[2]}{"g" if c[3] else ""} B={c[4]} '
                        f'{c[5] - t0:.3f}-{c[6] - t0:.3f}' for c in calls)
            + f'; the dispatch thread ran batches {busy:.3f} s of the '
            f'{burst_s:.3f} s burst')
        t5_ms = median_ms(lambda: t5(['a single prompt to time']), 5)
        log(f'serving: T5 encode of one prompt (fp32, 24 layers, 77 tokens): '
            f'{t5_ms:.3f} ms (CUDA events, median of 5); {CARD}')

        # eight identical seeded requests, twice as one batch: bit-equal
        ctx = pipe.embed_text(['one seeded prompt'])[0]
        rounds, batch_s = [], []
        calls.clear()
        reset_counts()
        for _ in range(2):
            before = eng.stats()['batches']
            t0 = time.perf_counter()
            futs = [eng.submit(GenerateRequest(context=ctx, timesteps=16,
                                               topk=5, seed=1234))
                    for _ in range(8)]
            rounds.append([f.result(timeout=600) for f in futs])
            batch_s.append(time.perf_counter() - t0)
            check(eng.stats()['batches'] == before + 1,
                  'the eight seeded requests did not run as one batch')
        check(all(np.array_equal(a, b) for a, b in zip(*rounds)),
              'one seeded batch, twice: different images')
        check(len({r.tobytes() for r in rounds[0]}) == 8,
              'the rows of one batch drew the same noise')
        counts = read_counts()
        check(len(calls) == 2 and counts == expected_launches(calls, cfg),
              f'seeded batches: launches {counts} for batches {calls}')
        for name, n in counts.items():
            totals[name] += n
        ctx8 = pipe.embed_text([f'a direct prompt {i}' for i in range(8)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = pipe.generate(text=ctx8, timesteps=16, topk=5,
                               decode_steps='final', generator=g)[-1]
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        check_images(direct, 'direct generate')
        log(f'serving: eight seeded requests as one batch, twice: bit-equal; '
            f'engine {min(batch_s):.3f} s per batch of 8 = '
            f'{8 / min(batch_s):.3f} images/s, Pipeline.generate directly '
            f'{direct_s:.3f} s = {8 / direct_s:.3f} images/s (B=8, 16 steps, '
            f'top-k 5): engine overhead {min(batch_s) - direct_s:+.3f} s; {CARD}')

    # /variations: an image-conditioned pipeline with a ViT-L/14 image tower
    tower = tclip.CLIPImageEmbedder(cfg=tclip.CLIPVisionConfig(),
                                    dtype=torch.bfloat16, seed=13)
    imgvar = pt.create_model('pipeline', 'paintmindv1-imgvar', pretrained=False,
                             stage1_checkpoint_path=ASSET, text_encoder=tower,
                             compute_dtype=torch.bfloat16)
    var_calls = []
    record_batches(imgvar, var_calls)
    with Served(imgvar, max_batch=8, max_wait_ms=100) as srv:
        reset_counts()
        status, out, seconds = post(srv.port, '/variations', {
            'image': png_b64(imgs[1]), 'num': 4, 'timesteps': 16, 'topk': 5,
            'seed': 7})
        counts = read_counts()
        check(status == 200 and len(out['images']) == 4
              and all(png_size(b) == (256, 256) for b in out['images']),
              f'/variations: {status} {str(out)[:200]}')
        check(len(set(out['images'])) == 4, '/variations: identical images')
        check(srv.engine.stats()['errors'] == 0, 'variations engine errors')
        check(counts == expected_launches(var_calls, imgvar.config),
              f'/variations: launches {counts} for batches {var_calls}')
        for name, n in counts.items():
            totals[name] += n
    with Served(pipe, max_batch=8, max_wait_ms=10) as srv:
        status, out, _ = post(srv.port, '/variations',
                              {'image': png_b64(imgs[1])})
        check(status == 400 and 'tower' in out['error'],
              f'/variations on the text pipeline: {status} {out}')
    clip_ms = median_ms(lambda: tower(imgs[:1].float()), 5)
    log(f'serving /variations (ViT-L/14 image tower, bf16, seeded random): 4 '
        f'images in {seconds:.3f} s, {len(var_calls)} batch(es), launches '
        f'{counts}; the text pipeline answers 400; the image tower on one '
        f'256² image {clip_ms:.3f} ms (CUDA events, median of 5); {CARD}')
    for p in (pipe, imgvar):  # the recording wrappers hold the pipelines
        del p.generate, p.paint, p.vqgan.reconstruct


# ---------------------------------------------------------------------------
# phase 7: stage-2 training
# ---------------------------------------------------------------------------

class SeededDataset:
    """(256² image, caption) items made from the item's index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        low = rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32)
        return np.kron(low, np.ones((16, 16, 1), np.float32)), f'caption {i}'


def text_embedder(captions):
    """A seeded stand-in for the text tower: caption -> (77, 1024)."""
    rows = [torch.randn(77, 1024, generator=torch.Generator().manual_seed(
        int(c.split()[-1]))) for c in captions]
    return torch.stack(rows).cuda()


def loss_and_grads(pipe, imgs, ctx, noise, **kw):
    pipe.zero_grad(set_to_none=True)
    loss = pipeline_loss(pipe, imgs, ctx, 0.6, noise=noise, **kw)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item()


def training(totals):
    pipe = pt.create_model('pipeline', 'paintmindv1', pretrained=False,
                           stage1_checkpoint_path=ASSET, text_encoder=None)
    cfg = pipe.config
    vq0 = [p.detach().clone() for p in pipe.vqgan.parameters()]
    trainable = pipe.trainable_parameters()
    for p in trainable:
        p.requires_grad_(True)
    n_train = sum(p.numel() for p in trainable)
    log(f'training: paintmindv1, {n_train / 1e6:.1f} M trainable parameters '
        f'(fp32 master weights, bf16 compute), VQGAN frozen')
    g = torch.Generator(device='cuda').manual_seed(7)
    imgs16 = seeded_images(16, 256, 3)
    ctx16 = torch.randn(16, 77, cfg.t5_dim, device='cuda', generator=g)
    imgs, ctx = imgs16[:8].bfloat16(), ctx16[:8].bfloat16()
    noise = torch.rand(8, cfg.num_tokens, device='cuda', generator=g)
    depth, enc = cfg.depth, cfg.vqc.enc.depth

    # 6.1 + 6.2: one microbatch, kernels against the plain attention
    # (dropout off: the transformer in eval mode), with the launch counts
    pipe.eval()
    named = dict(pipe.named_parameters())
    watched = ['mask_token', 'transformer.token_proj.weight',
               'transformer.to_logits.weight']
    watched += [f'transformer.layers.{i}.{a}.{w}.weight'
                for i in (0, depth - 1) for a in ('attn1', 'attn2')
                for w in ('to_q', 'to_k', 'to_v')]

    def grads():
        return {n: named[n].grad.clone() for n in watched}

    loss_w = loss_and_grads(pipe, imgs, ctx, noise)  # warm-up: cuBLAS, allocator
    grads_w = grads()
    loss_k, _ = drive(lambda: loss_and_grads(pipe, imgs, ctx, noise),
                      {'K1': enc + 2 * depth, 'K2': 1, 'K3': 0,
                       'K4': 2 * depth}, totals,
                      'train microbatch B=8 forward+backward')
    for p in trainable:
        check(p.grad is not None and bool(torch.isfinite(p.grad).all())
              and bool(p.grad.abs().max() > 0),
              'a trainable parameter has no finite, non-zero gradient')
    grads_k = grads()
    check(loss_w == loss_k and all(torch.equal(grads_w[n], grads_k[n])
                                   for n in watched),
          f'two runs of one microbatch differ: loss {loss_w} vs {loss_k}')
    del grads_w
    log('train microbatch: a second run gives the same loss and gradients, '
        'bit for bit')
    t0 = time.perf_counter()
    loss_and_grads(pipe, imgs, ctx, noise, remat=True)
    log(f'first remat call: {time.perf_counter() - t0:.3f} s (one-time '
        f'set-up inside torch.utils.checkpoint included)')
    loss_r, _ = drive(lambda: loss_and_grads(pipe, imgs, ctx, noise,
                                             remat=True),
                      {'K1': enc + 4 * depth, 'K2': 1, 'K3': 0,
                       'K4': 2 * depth}, totals,
                      'train microbatch B=8 forward+backward, remat')
    check(loss_r == loss_k and all(torch.equal(named[n].grad, grads_k[n])
                                   for n in watched),
          f'remat changed the loss or the gradients: {loss_r} vs {loss_k}')
    plain = dict(backend='plain', vq_backend='plain')
    unused = dict.fromkeys(totals, 0)
    loss_p, _ = drive(lambda: loss_and_grads(pipe, imgs, ctx, noise, **plain),
                      {'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0}, unused,
                      "train microbatch B=8, backend='plain'")
    grads_p = grads()
    # the yardstick for both bf16 runs: the plain attention in fp32
    loss_f = loss_and_grads(pipe, imgs.float(), ctx.float(), noise, **plain)
    grads_f = grads()
    log(f'train microbatch: loss kernels {loss_k:.5f}, plain {loss_p:.5f}, '
        f'plain fp32 {loss_f:.5f}, ln(8192) = {math.log(8192):.5f}')
    log('gradient mean rel err (kernels bf16 vs fp32 / plain bf16 vs fp32 / '
        'kernels vs plain, both bf16):')
    for n in watched:
        e_k, e_p, e_kp = (mean_rel(grads_k[n], grads_f[n]),
                          mean_rel(grads_p[n], grads_f[n]),
                          mean_rel(grads_k[n], grads_p[n]))
        log(f'  {n.replace("transformer.", ""):32s} {e_k:.3e} / {e_p:.3e} / '
            f'{e_kp:.3e}')
        # bf16 activations through 12 layers each way leave either path
        # some 13 % from fp32 at initialisation (measured, H100); the gate
        # is that the kernels are no farther from it than the plain path
        check(e_k <= 1.25 * e_p + 0.01 and e_k <= 0.2 and e_kp <= 0.15,
              f'gradient of {n}: rel err kernels {e_k}, plain {e_p}, '
              f'between them {e_kp}')
    check(abs(loss_k - loss_f) <= 2e-3 and abs(loss_k - loss_p) <= 2e-3,
          f'loss kernels {loss_k}, plain {loss_p}, fp32 {loss_f}')
    del grads_p, grads_f
    del grads_k
    pipe.zero_grad(set_to_none=True)

    # 6.3: six updates on one fixed batch, two microbatches of 8 each
    opt = pt.optim.lion(trainable, 1e-4, (0.9, 0.99), weight_decay=0.05,
                        max_grad_norm=1.0)
    step = make_pipeline_train_step(pipe, opt, grad_accum=2,
                                    compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def update():
            start.record()
            loss = step(imgs16, ctx16, 0.6)['loss']
            end.record()
            return loss
        loss, _ = drive(update, {'K1': 2 * (enc + 2 * depth), 'K2': 2,
                                 'K3': 0, 'K4': 4 * depth}, totals,
                        f'train update {i} B=16 grad_accum=2')
        losses.append(loss.item())
        times.append(start.elapsed_time(end) / 1e3)
    check(all(math.isfinite(x) for x in losses), f'losses {losses}')
    check(abs(losses[0] - math.log(8192)) <= 0.5,
          f'first loss {losses[0]} is not near ln 8192')
    check(losses[-1] < losses[0], f'loss did not fall: {losses}')
    sec = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'train updates (Lion, lr 1e-4, dropout {cfg.dropout}, 2 microbatches '
        f'of B=8): losses {" ".join(f"{x:.4f}" for x in losses)} (with P and '
        f'dS kept in fp32 by the CUDA-core kernels: 9.1262 first, 8.2962 '
        f'last); '
        f'{sec:.4f} s per update = {16 / sec:.2f} images/s (median of 5 '
        f'CUDA-event timed updates after the first), peak device memory '
        f'{peak:.2f} GiB; {CARD}')

    # 6.4: the trainer: three host steps through the DataLoader, save,
    # resume into a second trainer, evaluate
    with tempfile.TemporaryDirectory() as folder:
        def trainer_for(model):
            return pt.PaintMindTrainer(
                model, SeededDataset(30), num_epoch=1, valid_size=6,
                lr=1e-4, warmup_steps=2, decay_steps=10, batch_size=8,
                num_workers=4, save_every=100, sample_every=100,
                result_folder=folder, log_dir=os.path.join(folder, 'log'),
                text_embedder=text_embedder, seed=5)
        first = trainer_for(pipe)
        _, seconds = drive(first.train,
                           {'K1': 3 * (enc + 2 * depth), 'K2': 3, 'K3': 0,
                            'K4': 6 * depth}, totals,
                           'PaintMindTrainer.train() 3 host steps B=8 + save')
        check(first.steps == 3 and math.isfinite(first.log['loss']),
              f'trainer steps {first.steps}')
        second_pipe = pt.create_model(
            'pipeline', 'paintmindv1', pretrained=False,
            stage1_checkpoint_path=ASSET, text_encoder=None, seed=99)
        second = trainer_for(second_pipe).resume('auto')
        batch = next(iter(first.train_dl))
        want = first.train_step(batch)['loss'].item()
        got = second.train_step(batch)['loss'].item()
        check(second.steps == 4 and got == want,
              f'resumed trainer: next loss {got}, the first trainer\'s {want}')
        log(f'trainer: loss after 3 steps {first.log["loss"]:.4f}; resumed '
            f'trainer next-step loss {got:.6f} == {want:.6f}')
        del second, second_pipe
        dec = cfg.vqc.dec.depth
        drive(first.evaluate, {'K1': 18 * 2 * depth + dec, 'K2': 0,
                               'K3': 18, 'K4': 0}, totals,
              'PaintMindTrainer.evaluate() B=6 18 steps')
        grid = os.path.join(folder, 'images', f'step_{first.steps}_0.png')
        with Image.open(grid) as im:
            check(im.size[0] > 6 * 256, f'evaluate grid {im.size}')
    check(all(torch.equal(a, b) for a, b in zip(vq0, pipe.vqgan.parameters())),
          'training changed the frozen VQGAN')
    log('training: the frozen VQGAN is bit-equal to its start')
    return pipe


# ---------------------------------------------------------------------------
# phase 4b: a model of other head and code dims (C3)
# ---------------------------------------------------------------------------

TINY_VQ = {
    'n_embed': 512, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 64, 'patch_size': 8, 'dim': 64, 'depth': 2,
            'num_head': 4, 'mlp_dim': 128, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 64, 'patch_size': 8, 'dim': 64, 'depth': 2,
            'num_head': 4, 'mlp_dim': 128, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
TINY_PIPE = {'stage1': 'smoke-tiny-vqgan', 't5': 't5-l', 'dim': 64,
             'dim_head': 16, 'mlp_dim': 128, 'num_head': 4, 'depth': 2,
             'dropout': 0.0}


def tiny_pipeline(totals):
    """A registered model whose head dim (16) and code dim (8) are not the
    shipped ones, on the card through the kernels: K1 and K4 take head dim
    16 zero-padded to 64, K2 code dim 8 (compiled).  A seeded fp32
    ``generate`` (B = 4, 4 steps, top-k 5) and ``reconstruct`` (B = 4),
    launches as the path needs them; ``reconstruct`` against the plain
    versions: ids agree >= 0.999 and MAE <= 1e-3 (fp32, as phase 4); the
    generated images finite, in [-1, 1]; one B = 4 training microbatch of
    ``pipeline_loss`` with ``backward()`` launches K4 per attention."""
    pt.register_version('smoke-tiny-vqgan', TINY_VQ)
    pt.register_version('smoke-tiny-pipeline', TINY_PIPE)
    pipe = pt.create_model('pipeline', 'smoke-tiny-pipeline', pretrained=False,
                           text_encoder=None, seed=4)
    cfg = pipe.config
    g = torch.Generator(device='cuda').manual_seed(4)
    ctx = torch.randn(4, 77, cfg.t5_dim, device='cuda', generator=g)
    steps, depth, dec = 4, cfg.depth, cfg.vqc.dec.depth
    imgs, _ = drive(lambda: pipe.generate(text=ctx, timesteps=steps, topk=5,
                                          decode_steps='final', generator=g)[-1],
                    {'K1': depth * 2 * steps + dec, 'K3': steps}, totals,
                    'tiny pipeline (dim_head 16, embed_dim 8) generate B=4 4 steps')
    check(imgs.shape == (4, 64, 64, 3) and bool(torch.isfinite(imgs).all())
          and float(imgs.abs().max()) <= 1.0, f'tiny generate {imgs.shape}')
    x = seeded_images(4, 64, 6)
    enc = cfg.vqc.enc.depth
    rec, _ = drive(lambda: pipe.vqgan.reconstruct(x),
                   {'K1': enc + dec, 'K2': 1}, totals,
                   'tiny pipeline reconstruct B=4 fp32')
    plain = pipe.vqgan.reconstruct(x, backend='plain', vq_backend='plain')
    ids = pipe.vqgan.encode(x)[2]
    plain_ids = pipe.vqgan.encode(x, backend='plain', vq_backend='plain')[2]
    mae = (rec - plain).abs().mean().item()
    agree = (ids == plain_ids).float().mean().item()
    check(agree >= 0.999 and mae <= 1e-3,
          f'tiny reconstruct kernel vs plain: ids agree {agree}, MAE {mae}')
    trainable = pipe.trainable_parameters()
    for p in trainable:
        p.requires_grad_(True)
    noise = torch.rand(4, cfg.num_tokens, device='cuda', generator=g)
    drive(lambda: pipeline_loss(pipe, x, ctx, 0.5, noise=noise).backward(),
          {'K1': enc + 2 * depth, 'K2': 1, 'K4': 2 * depth}, totals,
          'tiny pipeline train microbatch B=4 forward+backward')
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in trainable), 'tiny pipeline: a gradient is missing')
    log(f'tiny pipeline: reconstruct kernel vs plain MAE={mae:.3e}, ids agree '
        f'{agree:.5f}; head dim {cfg.dim_head} runs the head-dim-'
        f'{fa.kernel_head_dim(cfg.dim_head)} kernels, code dim '
        f'{cfg.vqc.embed_dim} the code-dim-{vq.kernel_code_dim(cfg.vqc.embed_dim)} '
        f'kernel')


# ---------------------------------------------------------------------------
# phase 4c: the 512² variant (4096 tokens)
# ---------------------------------------------------------------------------

def variant_512(totals):
    """The 512² variant on the card.  ``adapt_vqmodel_resolution`` of the
    shipped weights builds ``vit-s-vqgan-512`` (position tables resized
    32² -> 64²); ``reconstruct`` at B = 2 through K1 (4096 tokens) and K2
    (T = 8192) against the plain versions at phase 4's fp32 gates (ids agree
    >= 0.999, MAE <= 1e-3).  Then ``paintmindv1-512``: seeded stage-2
    weights over that tokenizer; one fp32 ``generate`` (B = 2, 4 steps,
    top-k 5) through the kernels and through the plain attention, both
    drawing K3's noise from one seed: ids agree >= 0.999, image MAE <= 1e-3
    (the tiny pipeline's gate); one counted fp32 ``generate`` and a bf16
    ``generate`` at B = 2 for 16 steps, timed (images/s).  Every generate
    takes the re-mask's sort route (L > 2048): its call count
    (``pipeline.sort_remasks``) must equal the steps."""
    from paintmind_tpu_torch.convert.from_jax import load_jax_params
    from paintmind_tpu_torch.convert.resolution import adapt_vqmodel_resolution
    from paintmind_tpu_torch.models import pipeline as tpl

    flat = adapt_vqmodel_resolution(load_flat(ASSET), 4096)
    vq = load_jax_params(pt.create_model('vqgan', 'vit-s-vqgan-512',
                                         pretrained=False), flat)
    enc, dec = vq.config.enc.depth, vq.config.dec.depth
    x = seeded_images(2, 512, 21)
    rec, s_rec = drive(lambda: vq.reconstruct(x), {'K1': enc + dec, 'K2': 1},
                       totals, '512² reconstruct B=2 fp32 (4096 tokens)')
    plain = vq.reconstruct(x, backend='plain', vq_backend='plain')
    ids = vq.encode(x)[2]
    plain_ids = vq.encode(x, backend='plain', vq_backend='plain')[2]
    mae = (rec - plain).abs().mean().item()
    agree = (ids == plain_ids).float().mean().item()
    check(rec.shape == (2, 512, 512, 3) and bool(torch.isfinite(rec).all()),
          f'512² reconstruct {tuple(rec.shape)}')
    check(agree >= 0.999 and mae <= 1e-3,
          f'512² reconstruct kernel vs plain: ids agree {agree}, MAE {mae}')
    psnr = 10 * np.log10(4.0 / ((rec - x) ** 2).mean().item())
    log(f'512² reconstruct: kernel vs plain MAE={mae:.3e}, ids agree '
        f'{agree:.5f}, PSNR vs input {psnr:.2f} dB (position tables '
        f'interpolated from the 256² weights, not trained at 512²)')
    del rec, plain

    def pipeline(dtype):
        pipe = pt.create_model('pipeline', 'paintmindv1-512', pretrained=False,
                               text_encoder=None, compute_dtype=dtype, seed=5)
        load_jax_params(pipe.vqgan, flat)
        return pipe

    pipe = pipeline(None)
    cfg = pipe.config
    check(cfg.num_tokens == 4096, f'paintmindv1-512 has {cfg.num_tokens} tokens')
    depth = cfg.depth
    g = torch.Generator(device='cuda').manual_seed(0)
    ctx = torch.randn(2, 77, cfg.t5_dim, device='cuda', generator=g)
    init = torch.full((2, cfg.num_tokens), cfg.mask_token_id, dtype=torch.int32,
                      device='cuda')
    steps = 4
    runs = {}
    for backend in (None, 'plain'):
        tpl.sort_remasks = 0
        gen = torch.Generator(device='cuda').manual_seed(9)
        # the last step's display ids (masked slots hold their prediction),
        # which Pipeline.generate decodes
        _, shown = tpl.generate_ids(pipe, init, ctx, cfg=cfg, timesteps=steps,
                                    topk=5, backend=backend, generator=gen)
        check(tpl.sort_remasks == steps, f'512² generate ({backend}): '
              f'{tpl.sort_remasks} sort re-masks in {steps} steps')
        runs[backend] = (shown[-1], pipe.vqgan.decode_from_indice(
            shown[-1], backend=backend))
    agree = (runs[None][0] == runs['plain'][0]).float().mean().item()
    mae = (runs[None][1] - runs['plain'][1]).abs().mean().item()
    check(agree >= 0.999 and mae <= 1e-3,
          f'512² generate kernels vs plain attention: ids agree {agree}, MAE {mae}')
    log(f'512² generate fp32 B=2 {steps} steps, kernels vs plain attention '
        f'(K3 on one seed in both): ids agree {agree:.5f}, image MAE {mae:.3e}')
    del runs
    tpl.sort_remasks = 0
    imgs, _ = drive(lambda: pipe.generate(text=ctx, timesteps=steps, topk=5,
                                          decode_steps='final', generator=g)[-1],
                    {'K1': depth * 2 * steps + dec, 'K3': steps}, totals,
                    f'512² generate B=2 {steps} steps fp32')
    check(imgs.shape == (2, 512, 512, 3) and bool(torch.isfinite(imgs).all())
          and float(imgs.abs().max()) <= 1.0, f'512² generate {imgs.shape}')
    check(tpl.sort_remasks == steps, '512² generate did not take the sort route')
    del pipe, imgs
    gc.collect()

    pipe = pipeline(torch.bfloat16)
    steps = 16
    pipe.generate(text=ctx, timesteps=2, topk=5, decode_steps='final',
                  generator=g)  # warm-up
    tpl.sort_remasks = 0
    torch.cuda.reset_peak_memory_stats()
    imgs, sec = drive(lambda: pipe.generate(text=ctx, timesteps=steps, topk=5,
                                            decode_steps='final',
                                            generator=g)[-1],
                      {'K1': depth * 2 * steps + dec, 'K3': steps}, totals,
                      f'512² generate B=2 {steps} steps bf16')
    check(imgs.shape == (2, 512, 512, 3) and bool(torch.isfinite(imgs).all())
          and float(imgs.abs().max()) <= 1.0, f'512² bf16 generate {imgs.shape}')
    check(tpl.sort_remasks == steps,
          f'512² bf16 generate: {tpl.sort_remasks} sort re-masks')
    log(f'512² generate bf16 B=2 {steps} steps (incl. decode): {sec:.3f} s = '
        f'{2 / sec:.3f} images/s, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; reconstruct '
        f'B=2 fp32 {s_rec:.3f} s; {CARD}')


# ---------------------------------------------------------------------------
# phase 7b: stage-1 (VQGAN) training
# ---------------------------------------------------------------------------

def stage1_g_loss_and_grads(vqgan, d, lpips, img, dtype, backend=None,
                            vq_backend='auto'):
    """One microbatch's G loss and the VQGAN's gradients, D's state kept
    (its training-mode BatchNorm would move at each call)."""
    saved = {k: v.clone() for k, v in d.state_dict().items()}
    vqgan.zero_grad(set_to_none=True)
    z, cb_loss, _ = tvm.encode(vqgan, img.to(dtype), backend=backend,
                               vq_backend=vq_backend)
    rec = tvm.decode(vqgan, z, backend=backend).float()
    d.requires_grad_(False)
    total, _ = vqgan_g_loss(rec, cb_loss, d, img, lpips)
    total.backward()
    d.requires_grad_(True)
    d.load_state_dict(saved)
    torch.cuda.synchronize()
    return total.item()


def stage1_training(totals):
    """Stage-1 VQGAN training at ``vit-s-vqgan`` width (256² images, 1024
    tokens, 8 + 8 layers of dim 512, 8 heads of 64, an 8192 x 32 codebook)
    from the shipped weights, fp32 master weights and bf16 compute, the
    reference's discriminator (ndf 64, 3 layers, seeded), LPIPS 'random'
    (the repository has no converted VGG weights), B = 8 microbatches.

      * one microbatch's G loss and generator gradients through the kernels
        and through the plain attention and lookup, both in bf16, beside the
        plain path in fp32 as the yardstick.  Gates: the loss within 2e-3 of
        either; each watched gradient (the first and last layers' to_q / to_k
        / to_v of each stack, the codebook, prev_quant, post_quant, the
        decoder's projection) no farther from fp32 than 1.25 x the plain bf16
        path's distance + 0.01, below 0.2 mean relative, and within 0.15 of the
        plain bf16 path: bf16 activations through 8 layers each way leave
        either bf16 path some percent from fp32, and the gate is that the
        kernels are no farther from it than the plain path;
      * five updates of ``make_vqgan_train_step`` (share_forward,
        ``grad_accum=2``, EMA 0.999), timed (CUDA events) as the median
        after the first, each launching K1 and K4 once per layer and
        microbatch (32 each) and K2 once per encode (2); peak device memory;
      * a ``VQGANTrainer.train()`` of three updates with ``save()``,
        ``resume('auto')`` into a second trainer (whose next update on one
        batch must give the first trainer's loss, bit for bit) and one
        ``evaluate()`` whose PSNR is finite."""
    from paintmind_tpu_torch.models import discriminator as tdisc
    from paintmind_tpu_torch.models import lpips as tlpips
    vqgan = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=ASSET)
    cfg = vqgan.config
    enc, dec = cfg.enc.depth, cfg.dec.depth
    for p in vqgan.parameters():
        p.requires_grad_(True)
    log(f'stage-1 training: vit-s-vqgan, {vqgan.num_params / 1e6:.1f} M '
        f'parameters (fp32 master weights, bf16 compute) from the shipped '
        f'weights; head dim {cfg.enc.dim_head}, codebook {cfg.n_embed} x '
        f'{cfg.embed_dim}')
    lpips = tlpips.LPIPS(seed=0)
    d = tdisc.Discriminator(seed=1)
    imgs16 = seeded_images(16, 256, 11)
    img = imgs16[:8]

    named = dict(vqgan.named_parameters())
    watched = [f'{s}.layers.{i}.attn1.{w}.weight'
               for s in ('encoder', 'decoder') for i in (0, 7)
               for w in ('to_q', 'to_k', 'to_v')]
    watched += ['quantize.codebook', 'prev_quant.weight', 'post_quant.weight',
                'decoder.proj.weight']

    def grads():
        return {n: named[n].grad.clone() for n in watched}

    bf = torch.bfloat16
    stage1_g_loss_and_grads(vqgan, d, lpips, img, bf)  # warm-up
    loss_k, _ = drive(lambda: stage1_g_loss_and_grads(vqgan, d, lpips, img, bf),
                      {'K1': enc + dec, 'K2': 1, 'K4': enc + dec}, totals,
                      'stage-1 microbatch B=8 G loss + backward')
    grads_k = grads()
    unused = dict.fromkeys(totals, 0)
    plain = dict(backend='plain', vq_backend='plain')
    loss_p, _ = drive(lambda: stage1_g_loss_and_grads(
        vqgan, d, lpips, img, bf, **plain), {}, unused,
        "stage-1 microbatch B=8, backend='plain'")
    grads_p = grads()
    loss_f = stage1_g_loss_and_grads(vqgan, d, lpips, img, torch.float32,
                                     **plain)
    grads_f = grads()
    log(f'stage-1 microbatch G loss: kernels {loss_k:.5f}, plain {loss_p:.5f}, '
        f'plain fp32 {loss_f:.5f}')
    log('stage-1 gradient mean rel err (kernels bf16 vs fp32 / plain bf16 vs '
        'fp32 / kernels vs plain, both bf16):')
    for n in watched:
        e_k, e_p, e_kp = (mean_rel(grads_k[n], grads_f[n]),
                          mean_rel(grads_p[n], grads_f[n]),
                          mean_rel(grads_k[n], grads_p[n]))
        log(f'  {n:34s} {e_k:.3e} / {e_p:.3e} / {e_kp:.3e}')
        check(e_k <= 1.25 * e_p + 0.01 and e_k <= 0.2 and e_kp <= 0.15,
              f'stage-1 gradient of {n}: rel err kernels {e_k}, plain {e_p}, '
              f'between them {e_kp}')
    check(abs(loss_k - loss_f) <= 2e-3 and abs(loss_k - loss_p) <= 2e-3,
          f'stage-1 G loss kernels {loss_k}, plain {loss_p}, fp32 {loss_f}')
    del grads_k, grads_p, grads_f
    vqgan.zero_grad(set_to_none=True)

    # five updates of the step function, two microbatches of 8 each
    def tx(params):
        return pt.optim.adam(params, 1e-4, (0.9, 0.99), 1.0)

    step = make_vqgan_train_step(vqgan, tx, tx, lpips=lpips, grad_accum=2,
                                 compute_dtype=torch.bfloat16, ema_decay=0.999,
                                 seed=2)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def update():
            start.record()
            m = step(imgs16)
            end.record()
            return m

        m, _ = drive(update, {'K1': 2 * (enc + dec), 'K2': 2,
                              'K4': 2 * (enc + dec)}, totals,
                     f'stage-1 update {i} B=16 grad_accum=2')
        losses.append({k: v.item() for k, v in m.items()})
        times.append(start.elapsed_time(end) / 1e3)
    check(all(math.isfinite(v) for m in losses for v in m.values()),
          f'stage-1 metrics {losses}')
    sec = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log('stage-1 updates (Adam 1e-4, share_forward, 2 microbatches of B=8, '
        'EMA): ' + '; '.join(
            f'loss {m["loss"]:.4f} rec {m["rec loss"]:.4f} per '
            f'{m["per loss"]:.4f} g {m["g loss"]:.4f} d {m["d loss"]:.4f}'
            for m in losses))
    log(f'stage-1 update: {sec:.4f} s per update = {16 / sec:.2f} images/s '
        f'(median of 4 CUDA-event timed updates after the first), peak device '
        f'memory {peak:.2f} GiB; {CARD}')
    del step

    # the trainer: three updates through the DataLoader, save, resume into
    # a second trainer, evaluate
    with tempfile.TemporaryDirectory() as folder:
        def trainer_for(model):
            return pt.VQGANTrainer(
                model, SeededDataset(30), num_epoch=1, valid_size=6, lr=1e-4,
                warmup_steps=2, batch_size=8, num_workers=4, save_every=100,
                sample_every=100, result_folder=folder,
                log_dir=os.path.join(folder, 'log'),
                perceptual_weights='random', ema_decay=0.999, seed=5)
        first = trainer_for(vqgan)
        drive(first.train, {'K1': 3 * (enc + dec), 'K2': 3,
                            'K4': 3 * (enc + dec)}, totals,
              'VQGANTrainer.train() 3 updates B=8 + save')
        check(first.steps == 3 and math.isfinite(first.log['loss']),
              f'VQGANTrainer steps {first.steps}')
        second_vq = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=ASSET)
        second = trainer_for(second_vq).resume('auto')
        batch = next(iter(first.train_dl))
        want = first.train_step(batch)['loss'].item()
        got = second.train_step(batch)['loss'].item()
        check(second.steps == 4 and got == want,
              f"resumed VQGANTrainer: next loss {got}, the first trainer's {want}")
        del second, second_vq
        drive(first.evaluate, {'K1': enc + dec, 'K2': 1}, totals,
              'VQGANTrainer.evaluate() B=6 fp32')
        check(math.isfinite(first.log['val psnr']),
              f"evaluate PSNR {first.log['val psnr']}")
        log(f"VQGANTrainer: loss after 3 updates {first.log['loss']:.4f}; "
            f'resumed trainer next loss {got:.6f} == {want:.6f}; evaluate: '
            f"PSNR {first.log['val psnr']:.3f} dB, codebook usage "
            f"{first.log['codebook usage']:.4f}, perplexity "
            f"{first.log['codebook perplexity']:.1f}")
    return vqgan, d, lpips, imgs16[:8]


# ---------------------------------------------------------------------------
# phase 7c: the command lines
# ---------------------------------------------------------------------------

# The native (C++, libjpeg) loader of ``train_vqgan --native-loader`` is not
# driven here: the H100 machine this script is run on has no libjpeg
# headers (``jpeglib.h``), so the library cannot be built there.  The CPU
# tests hold it against the JAX package's library.
NATIVE_LOADER = False


def write_jpegs(folder, n):
    """``n`` smooth seeded JPEGs, two of every three non-square (resize and
    crop run), between 256 and 448 pixels a side."""
    os.makedirs(folder)
    rng = np.random.default_rng(31)
    sizes = ((448, 320), (320, 320), (256, 384))
    for i in range(n):
        low = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        Image.fromarray(low).resize(sizes[i % 3], Image.BICUBIC).save(
            os.path.join(folder, f'img_{i:02d}.jpg'), quality=90)
    return folder


def command_lines(totals):
    """The four command lines, called in process through ``main(argv)`` at
    full width on 40 seeded JPEGs: ``train_vqgan`` from the shipped weights
    (LPIPS 'random', B = 8, one update: 40 images less the trainer's 32 held
    out), ``train_paintmind`` over the tokenizer that run exported (B = 8,
    three updates, unconditional: a folder has no captions), ``generate``
    from the pipeline that run exported (16 steps) and ``--mode inpaint`` on
    one of the JPEGs, and ``convert_checkpoint`` on a ``.pt`` written from
    a seeded VQGAN in the reference's state-dict layout, whose archive and
    whose ``.pt`` both load to the seeded weights.  Finite losses, the
    files written, the PNGs' sizes and every command's launches."""
    from paintmind_tpu_torch.convert.from_jax import to_flat
    from paintmind_tpu_torch.convert.torch_weights import to_reference
    from paintmind_tpu_torch.scripts import (convert_checkpoint, generate,
                                             train_paintmind, train_vqgan)
    vcfg = pt.ver2cfg['vit-s-vqgan']
    enc, dec = vcfg['enc']['depth'], vcfg['dec']['depth']
    depth = pt.ver2cfg['paintmindv1']['depth']
    with tempfile.TemporaryDirectory() as tmp:
        data = write_jpegs(os.path.join(tmp, 'jpegs'), 40)
        common = ['--batch-size', '8', '--grad-accum', '1', '--epochs', '1',
                  '--sample-every', '1000', '--num-workers', '8',
                  '--log-dir', os.path.join(tmp, 'log')]
        argv = ['--dataset', f'folder:{data}', '--init-checkpoint', ASSET,
                '--perceptual', 'random', '--save-every', '1',
                '--result-folder', os.path.join(tmp, 'vqgan'), *common]
        if NATIVE_LOADER:
            argv.append('--native-loader')
        s1, sec1 = drive(lambda: train_vqgan.main(argv),
                         {'K1': enc + dec, 'K2': 1, 'K4': enc + dec}, totals,
                         'train_vqgan: 1 update B=8 + save')
        models = os.path.join(tmp, 'vqgan', 'models')
        check(s1.steps == 1 and math.isfinite(s1.log['loss'])
              and math.isfinite(s1.log['rec loss']),
              f'train_vqgan: steps {s1.steps}, log {s1.log.data}')
        check(sorted(os.listdir(models)) == ['vit_vq_state_1.pt',
                                             'vit_vq_step_1.npz'],
              f'train_vqgan wrote {os.listdir(models)}')
        stage1 = os.path.join(models, 'vit_vq_step_1.npz')
        del s1
        gc.collect()

        s2, sec2 = drive(lambda: train_paintmind.main([
            '--dataset', f'folder:{data}', '--stage1-checkpoint', stage1,
            '--save-every', '3', '--result-folder',
            os.path.join(tmp, 'paintmind'), *common]),
            {'K1': 3 * (enc + 2 * depth), 'K2': 3, 'K4': 3 * 2 * depth},
            totals, 'train_paintmind: 3 updates B=8 + save')
        models = os.path.join(tmp, 'paintmind', 'models')
        check(s2.steps == 3 and math.isfinite(s2.log['loss']),
              f'train_paintmind: steps {s2.steps}, log {s2.log.data}')
        check(sorted(os.listdir(models)) == ['paintmind_state_3.pt',
                                             'paintmind_step_3.npz'],
              f'train_paintmind wrote {os.listdir(models)}')
        loss2 = s2.log['loss']
        del s2
        gc.collect()

        pipeline = os.path.join(models, 'paintmind_step_3.npz')
        out = os.path.join(tmp, 'samples.png')
        imgs, sec3 = drive(lambda: generate.main([
            '--checkpoint', pipeline, '--timesteps', '16', '--out', out]),
            {'K1': 2 * depth * 16 + dec, 'K3': 16}, totals,
            'generate: 16 steps B=1 fp32')
        check(imgs.shape == (1, 256, 256, 3) and np.isfinite(imgs).all()
              and Image.open(out).size == (260, 260),
              f'generate: {imgs.shape}, PNG {Image.open(out).size}')
        out = os.path.join(tmp, 'inpaint.png')
        painted, sec4 = drive(lambda: generate.main([
            '--checkpoint', pipeline, '--timesteps', '16', '--out', out,
            '--mode', 'inpaint', '--image', os.path.join(data, 'img_00.jpg')]),
            {'K1': enc + 2 * depth * 16 + dec, 'K2': 1, 'K3': 16}, totals,
            'generate --mode inpaint: 16 steps B=1 fp32')
        check(painted.shape == (1, 256, 256, 3) and np.isfinite(painted).all()
              and Image.open(out).size == (260, 260),
              f'inpaint: {painted.shape}, PNG {Image.open(out).size}')

        seeded = pt.create_model('vqgan', 'vit-s-vqgan', pretrained=False,
                                 seed=13)
        src = os.path.join(tmp, 'reference.pt')
        torch.save(to_reference(to_flat(seeded)), src)
        t0 = time.perf_counter()
        npz = convert_checkpoint.main([src, os.path.join(tmp, 'converted.npz')])
        sec5 = time.perf_counter() - t0
        from_npz = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=npz)
        from_pt = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=src)
        for model in (from_npz, from_pt):
            for (name, a), (_, b) in zip(model.state_dict().items(),
                                         seeded.state_dict().items()):
                check(torch.equal(a, b), f'convert_checkpoint: {name} differs')
        x = seeded_images(2, 256, 17)
        drive(lambda: from_pt.reconstruct(x), {'K1': enc + dec, 'K2': 1},
              totals, 'reconstruct B=2 from the reference .pt')
    log(f'command lines: train_vqgan {sec1:.2f} s, train_paintmind {sec2:.2f} s '
        f'(loss {loss2:.4f}), generate {sec3:.2f} s, inpaint {sec4:.2f} s, '
        f'convert_checkpoint {sec5:.2f} s (each including its model set-up, '
        f'data and file writes; host clock); native loader: '
        f'{"driven" if NATIVE_LOADER else "not driven (no libjpeg headers)"}')


# the bf16 attention kernels, which must run their products on the tensor cores
TENSOR_CORE_KERNELS = {'flash_attention': ['attn_fwd_wgmma'],
                       'flash_attention_bwd': ['attn_bwd_dq_wgmma',
                                               'attn_bwd_dkdv_wgmma']}


def short_name(entry):
    """A mangled kernel name in readable form: ``attn_fwd_wgmma<1>``,
    ``vq_lookup<4>``, ``sample_rows<bf16,5>``, ``unpack_keys``."""
    found = re.search(r'\d+((?:attn|vq|sample|unpack)_[a-z0-9_]+?)'
                      r'(?:I(\w+?)EE|E)', entry)
    if not found:
        return entry
    name, args = found.groups()
    if args:
        args = re.sub(r'^f', 'fp32,', args.replace('13__nv_bfloat16', 'bf16,'))
        name += '<' + re.sub(r'L[ib](\d+)E?', r'\1,', args).rstrip(',') + '>'
    return name


def read_sass(name):
    return subprocess.run(
        [_build.cuda_tool('cuobjdump'), '-sass', str(_build.library_path(name))],
        capture_output=True, text=True, check=True).stdout


def sass_of(sass, entry):
    """The part of a ``cuobjdump -sass`` listing that is ``entry``'s code."""
    parts = sass.split('Function : ')
    return next((p for p in parts if p.startswith(entry)), '')


def report_build(name, seconds, sass):
    """One line per kernel of the library ``name``: registers, shared memory
    and spills from ``ptxas -v``, and how often its SASS (``read_sass``)
    shows the tensor-core opcodes (``HGMMA`` for wgmma, ``HMMA`` for mma.sync),
    ``ldmatrix`` (``LDSM``) and ``cp.async`` (``LDGSTS``) in it.  Fails on a
    spill, on a bf16 attention kernel without a tensor-core opcode and on a
    codebook lookup whose tiles do not come in by ``cp.async``."""
    log(f'build {name}: {seconds:.1f} s')
    entry = None
    usage = {}
    for ln in _build.build_log(name).splitlines():
        if 'Compiling entry function' in ln:
            entry = ln.split("'")[1]
            usage[entry] = []
        elif entry and ('spill' in ln or 'registers' in ln):
            usage[entry].append(ln.replace('ptxas info    :', '').strip())
    counts = {}
    for ln in sass.splitlines():
        if 'Function :' in ln:
            entry = ln.split('Function :')[1].strip()
            counts[entry] = dict.fromkeys(('HGMMA', 'HMMA', 'LDSM', 'LDGSTS'), 0)
        else:
            for op in counts.get(entry, ()):
                counts[entry][op] += f' {op}' in ln
    faults = []
    for entry, lines in usage.items():
        check(entry in counts, f'{entry} is not in the compiled library')
        ops = counts[entry]
        log(f'  {short_name(entry)}: {"; ".join(lines)}; SASS '
            + ' '.join(f'{op}={n}' for op, n in ops.items()))
        if not any('0 bytes spill stores, 0 bytes spill loads' in ln
                   for ln in lines):
            faults.append(f'{entry} spills registers')
            local = [ln.strip() for ln in sass_of(sass, entry).splitlines()
                     if re.search(r' (STL|LDL|CALL)', ln)]
            log('    local-memory and call instructions:\n      '
                + '\n      '.join(local[:12]))
        if any(k in entry for k in TENSOR_CORE_KERNELS.get(name, ())) \
                and ops['HGMMA'] + ops['HMMA'] == 0:
            faults.append(f'{entry} does not use the tensor cores')
        if short_name(entry).startswith('vq_lookup') and ops['LDGSTS'] == 0:
            faults.append(f'{entry} does not copy with cp.async')
    check(not faults, '; '.join(faults))
    for kernel in TENSOR_CORE_KERNELS.get(name, ()):
        check(any(kernel in entry for entry in usage),
              f'{kernel} was not compiled')


def profile_window(fn, what):
    """One ``torch.profiler`` window over ``fn`` (which ends synchronised):
    the ten device operations with the most time, the sum of device time
    and its share of the window.  Report only: nothing is gated on it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # kernels and device copies only: a host-side operator's row repeats
    # the device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f'profile {what}: key_averages() shows no device time on this '
            f'machine; window {window_ms:.3f} ms on the host clock')
        return
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    log(f'profile {what}: window {window_ms:.3f} ms (host clock, profiler on), '
        f'device time {busy:.3f} ms = {100 * busy / window_ms:.1f} % of the '
        f'window, {sum(r[1] for r in rows)} device operations of '
        f'{len(rows)} kinds; the ten with the most time (calls, ms, name):')
    for name, calls, ms in rows[:10]:
        log(f'  {calls:6d} {ms:10.3f}  {name[:200]}')


def profiles(serving, trained, stage1):
    """Where the time of one unguided ``generate`` (the stage-2 phase's
    bf16 pipeline), of one stage-2 training microbatch (the training phase's
    pipeline) and of one stage-1 microbatch's G loss and backward (the
    stage-1 training phase's VQGAN, discriminator and LPIPS) goes on the
    device."""
    cfg = serving.config
    g = torch.Generator(device='cuda').manual_seed(0)
    ctx = torch.randn(8, 77, cfg.t5_dim, device='cuda', generator=g)
    profile_window(lambda: serving.generate(
        text=ctx, timesteps=16, topk=5, decode_steps='final', generator=g),
        'generate B=8 16 steps bf16')
    trained.eval()
    imgs = seeded_images(8, 256, 3).bfloat16()
    ctx = ctx.bfloat16()
    noise = torch.rand(8, cfg.num_tokens, device='cuda', generator=g)
    profile_window(lambda: loss_and_grads(trained, imgs, ctx, noise),
                   'train microbatch B=8 forward+backward')
    vqgan, d, lpips, img = stage1
    profile_window(lambda: stage1_g_loss_and_grads(vqgan, d, lpips, img,
                                                   torch.bfloat16),
                   'stage-1 microbatch B=8 G loss + backward (bf16)')


# the libraries each kernel's check needs
KERNEL_LIBRARIES = {'K1': ('flash_attention',),
                    'K2': ('vq_lookup',), 'K3': ('sampling',),
                    'K3r': ('sampling',),
                    'K4': ('flash_attention', 'flash_attention_bwd')}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke.py: no CUDA device available', file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    global CARD
    CARD = card
    log(card)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {'K1': check_k1, 'K2': check_k2, 'K3': check_k3,
              'K3r': check_k3_radix, 'K4': check_k4}
    only = sys.argv[1:]
    if any(name not in checks for name in only):
        sys.exit(f'usage: chip_smoke.py [{" ".join(checks)}]')
    libraries = _build.KERNELS if not only else tuple(dict.fromkeys(
        lib for name in only for lib in KERNEL_LIBRARIES[name]))
    t0 = time.perf_counter()
    seconds = _build.build(libraries)
    with ThreadPoolExecutor(len(libraries)) as pool:  # one cuobjdump each
        sass = dict(zip(libraries, pool.map(read_sass, libraries)))
    for name in libraries:
        report_build(name, seconds[name], sass[name])
    log(f'build (one nvcc per source, in parallel): '
        f'{time.perf_counter() - t0:.1f} s')
    g = torch.Generator(device='cuda').manual_seed(0)
    if only:
        for name in only:
            checks[name](g)
            torch.cuda.synchronize()
        log(f'checked {" ".join(only)} only: {time.perf_counter() - t_start:.1f} s')
        return

    def phase(what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        # what a phase left in reference cycles (an HTTP server's handler
        # class holds its engine and pipeline) must not stay on the card
        gc.collect()
        torch.cuda.empty_cache()
        log(f'phase {what}: {time.perf_counter() - t0:.1f} s')
        return out

    results = {name: phase(f'check {name}', fn, g) for name, fn in checks.items()}
    totals = {name: 0 for name in KERNEL_COUNTERS}
    phase('stage 1', stage1, totals)
    phase('tiny pipeline', tiny_pipeline, totals)
    phase('512²', variant_512, totals)
    serving = phase('stage 2', stage2, totals)
    serving.to('cpu')  # out of the later phases' peak memory
    before = torch.cuda.memory_allocated()
    phase('serving', serving_phase, totals)
    held = torch.cuda.memory_allocated() - before
    # each thread that ran a product has its own cuBLAS handle and workspace,
    # kept by PyTorch until cleared: here the handler threads' tower encodes
    torch._C._cuda_clearCublasWorkspaces()
    log(f'serving: device memory still allocated after the phase '
        f'{held / 2**30:.3f} GiB, after clearing the cuBLAS workspaces '
        f'{(torch.cuda.memory_allocated() - before) / 2**30:.3f} GiB')
    trained = phase('training', training, totals)
    trained.to('cpu')  # out of the stage-1 phase's peak memory
    stage1_parts = phase('stage-1 training', stage1_training, totals)
    phase('command lines', command_lines, totals)
    for name, n in totals.items():
        check(n > 0, f'{name} never launched on the main path')
    phase('profiles', profiles, serving.to('cuda'), trained.to('cuda'),
          stage1_parts)

    meta = {
        'K1': ('flash_attention_fwd', 'cuda',
               'paintmind_tpu_torch/csrc/flash_attention.cu',
               'paintmind_tpu/ops/flash_attention.py:60'),
        'K2': ('vq_lookup_fwd', 'cuda', 'paintmind_tpu_torch/csrc/vq_lookup.cu',
               'paintmind_tpu/ops/vq_lookup.py:81'),
        'K3': ('fused_gumbel_topk_sample', 'cuda',
               'paintmind_tpu_torch/csrc/sampling.cu',
               'paintmind_tpu/ops/sampling.py:136'),
        'K3r': ('fused_gumbel_topk_sample (k > 16, radix select)', 'cuda',
                'paintmind_tpu_torch/csrc/sampling.cu',
                'paintmind_tpu/ops/sampling.py:136'),
        'K4': ('flash_attention_bwd', 'cuda',
               'paintmind_tpu_torch/csrc/flash_attention_bwd.cu',
               'paintmind_tpu/ops/flash_attention.py:195'),
    }
    kernels = []
    for key, (name, route, source, replaces) in meta.items():
        r = results[key]
        kernels.append({'name': f'{key} {name}', 'route': route,
                        'source': source, 'replaces': replaces,
                        'launches': totals[key],
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})
    log(f'total {time.perf_counter() - t_start:.1f} s')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
