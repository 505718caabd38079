#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paintmind_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line(s); any failure raises and the script
exits non-zero with no result line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. builds kernels K1-K4 from the sources in this checkout (one ``nvcc``
     per CUDA source, all at once; the Triton kernel by its first launch),
     prints each CUDA kernel's registers, shared memory and spills, and
     checks in the compiled code that the bf16 attention kernels run their
     products on the tensor cores (``HGMMA`` in the SASS) and spill nothing;
  3. holds each kernel against its plain PyTorch version at the main
     path's shapes, and times kernel, plain version and (where one exists)
     the PyTorch library call, beside the least time the card could take;
  4. stage 1: the shipped vit-s-vqgan weights reconstruct 8 seeded 256²
     images through the kernels and through the plain versions;
  5. stage 2: a full-width paintmindv1 pipeline (seeded random stage-2
     weights, bf16) runs a 16-step ``generate`` at B = 8, the same with
     classifier-free guidance, and an ``inpaint``; the launch counters must
     show each kernel on that path, at the expected counts;
  6. stage-2 training at the same width (fp32 master weights, bf16
     compute): one microbatch of B = 8 through ``pipeline_loss`` and
     ``backward()`` with the kernels and with the plain attention, loss and
     gradients compared; its launch counts without and with remat; six
     updates of the step function (Lion, dropout on, two microbatches
     each), timed; a short ``PaintMindTrainer.train()`` with ``save()``,
     ``resume('auto')`` into a second trainer and one ``evaluate()``;
  7. one ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero when there is none.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

import paintmind_tpu_torch as pt
from paintmind_tpu_torch.models import quantize as tq
from paintmind_tpu_torch.models.pipeline import (
    _transformer_logits, ids_to_tokens, pipeline_loss)
from paintmind_tpu_torch.ops import _build
from paintmind_tpu_torch.ops import flash_attention as fa
from paintmind_tpu_torch.ops import sampling as sm
from paintmind_tpu_torch.ops import vq_lookup as vq
from paintmind_tpu_torch.train.steps import make_pipeline_train_step
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
                   'K3': (sm, 'launches'), 'K4': (fa, 'launches_bwd')}


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
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check_k1(g):
    """K1 against ``flash_attention_plain`` at stage-2 self (H = 16,
    M = 1024), cross (M = 77) and VQGAN (H = 8) attention at B = 8 and a
    ragged case (B = 2, N = 200, M = 77, H = 3), fp32 and bf16.  Gates: fp32
    max abs <= 1e-4; bf16 mean abs <= 5e-3 (the kernel rounds the
    unnormalised p to bf16 and divides by the fp32 sum afterwards, the plain
    version rounds the normalised probabilities: measured 3e-4 at most, one
    bf16 rounding of values below 1), and mean abs <= 1e-5 against the tiled
    emulation, which rounds where the kernel does (measured 2e-7: only the
    order of the fp32 sums and the hardware's exp2 differ).  The log-sum-exp
    output against ``torch.logsumexp`` of the fp32 scaled scores: max abs
    <= 1e-3 in bf16 (measured 1e-6), <= 1e-5 in fp32.  Times every shape;
    the result line carries the main path's most frequent call, stage-2
    self-attention in bf16."""
    scale = 64 ** -0.5
    entry = None
    for label, b, n, m, h in (('stage-2 self', 8, 1024, 1024, 16),
                              ('stage-2 cross', 8, 1024, 77, 16),
                              ('vqgan self', 8, 1024, 1024, 8),
                              ('ragged', 2, 200, 77, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            d = 64
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
            if label != 'ragged':
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
    Times both training shapes; the result line carries the main path's
    most frequent call, stage-2 self-attention in bf16, beside the backward
    of ``F.scaled_dot_product_attention`` on a retained graph."""
    scale = 64 ** -0.5
    entry = None
    for label, b, n, m, h in (('stage-2 self', 8, 1024, 1024, 16),
                              ('stage-2 cross', 8, 1024, 77, 16),
                              ('ragged', 2, 200, 77, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            d = 64
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
            if label != 'ragged':
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


def check_k2(g):
    """T = 8·1024 l2-normalised queries against the shipped 8192 x 32
    codebook.  Indices equal, except at near-ties (score gap < 1e-5)."""
    codebook = load_flat(ASSET)['quantize/codebook'].float().cuda()
    e = tq.l2norm(codebook).contiguous()
    z = tq.l2norm(torch.randn(8 * 1024, 32, device='cuda', generator=g))
    got = vq.fused_nearest_codes(z, e)
    ref = vq.nearest_codes_plain(z, e)
    scores = z @ e.t()
    rows = torch.arange(z.shape[0], device='cuda')
    gap = (scores[rows, got.long()] - scores[rows, ref.long()]).abs()
    differ = int((got != ref).sum())
    max_gap = gap.max().item()
    check(max_gap < 1e-5, f'K2 disagrees beyond a near-tie: gap {max_gap}')
    ms = time_ms(lambda: vq.fused_nearest_codes(z, e), 20)
    plain_ms = time_ms(lambda: vq.nearest_codes_plain(z, e), 20)
    lib_ms = time_ms(lambda: torch.argmax(z @ e.t(), dim=-1), 20)
    t, c, d = z.shape[0], e.shape[0], z.shape[1]
    bms, by = bound((t * d + c * d) * 4 + t * 4, 2 * t * c * d, torch.float32)
    log(f'K2 T={t} C={c} D={d} fp32: {differ} of {t} ids differ '
        f'(max score gap {max_gap:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} '
        f'argmax_matmul_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by})')
    return dict(max_abs_err=max_gap, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


# operations per logit that the sampling function cannot avoid, whatever
# the algorithm: the row max (1), exp(l - max) and its sum (3), and one
# compare for the top-k selection (1).  The noise, the temperature and the
# argmax touch only the k survivors, and conf is one exp per row.
K3_OPS_PER_LOGIT = 5


def check_k3(g):
    """(8·1024, 8192) logits, top-k 5.  Temperature 1e-10 on distinct fp32
    logits: pred equal to the plain version, conf within 1e-6.  Temperature
    1: pred in the exact top-5 set, conf = softmax(logits)[pred] within
    1e-5 (fp32 and bf16 logits), and over 8192 draws of one row the
    frequencies match the top-5 softmax within 0.02."""
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

    lb = logits.to(torch.bfloat16)  # the pipeline's logits type
    noise = noise.to(torch.bfloat16)
    ms = time_ms(lambda: sm.fused_gumbel_topk_sample(lb, 1.0, k, generator=g), 20)
    plain_ms = time_ms(lambda: sm.gumbel_topk_sample_plain(lb, 1.0, k, noise), 5)
    nbytes = t * v * lb.element_size() + t * 4 + t * (4 + 4)
    bms, by = bound(nbytes, t * v * K3_OPS_PER_LOGIT, torch.float32)
    log(f'K3 T={t} V={v} k={k}: temp 1e-10 conf_err={conf_err:.3e}; temp 1 '
        f'top-5 softmax frequency err={dist_err:.4f} over 8192 draws; bf16 '
        f'ms={ms:.4f} plain_ms={plain_ms:.4f} (noise given) '
        f'bound_ms={bms:.4f} ({by})')
    return dict(max_abs_err=conf_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
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
    """Run one main-path call with the counters at 0; check and add them."""
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


# ---------------------------------------------------------------------------
# phase 6: stage-2 training
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


# the bf16 attention kernels, which must run their products on the tensor cores
TENSOR_CORE_KERNELS = {'flash_attention': ['attn_fwd_wgmma'],
                       'flash_attention_bwd': ['attn_bwd_dq_wgmma',
                                               'attn_bwd_dkdv_wgmma']}


def report_build(name, seconds):
    """One line per kernel of the library ``name``: registers, shared memory
    and spills from ``ptxas -v``, and how often ``cuobjdump -sass`` shows the
    tensor-core opcodes (``HGMMA`` for wgmma, ``HMMA`` for mma.sync),
    ``ldmatrix`` (``LDSM``) and ``cp.async`` (``LDGSTS``) in it.  Fails on a
    spill, and on a bf16 attention kernel without a tensor-core opcode."""
    log(f'build {name}: {seconds:.1f} s')
    entry = None
    usage = {}
    for ln in _build.build_log(name).splitlines():
        if 'Compiling entry function' in ln:
            entry = ln.split("'")[1]
            usage[entry] = []
        elif entry and ('spill' in ln or 'registers' in ln):
            usage[entry].append(ln.replace('ptxas info    :', '').strip())
    sass = subprocess.run(
        [_build.cuda_tool('cuobjdump'), '-sass', str(_build.library_path(name))],
        capture_output=True, text=True, check=True).stdout
    counts = {}
    for ln in sass.splitlines():
        if 'Function :' in ln:
            entry = ln.split('Function :')[1].strip()
            counts[entry] = dict.fromkeys(('HGMMA', 'HMMA', 'LDSM', 'LDGSTS'), 0)
        else:
            for op in counts.get(entry, ()):
                counts[entry][op] += f' {op}' in ln
    for entry, lines in usage.items():
        check(entry in counts, f'{entry} is not in the compiled library')
        ops = counts[entry]
        short = re.search(r'\d((?:attn|vq)_[a-z0-9_]+?)(?:ILi|EPK)', entry)
        log(f'  {short.group(1) if short else entry}: {"; ".join(lines)}; SASS '
            + ' '.join(f'{op}={n}' for op, n in ops.items()))
        check(any('0 bytes spill stores, 0 bytes spill loads' in ln
                  for ln in lines), f'{entry} spills registers')
        if any(k in entry for k in TENSOR_CORE_KERNELS.get(name, ())):
            check(ops['HGMMA'] + ops['HMMA'] > 0,
                  f'{entry} does not use the tensor cores')
    for kernel in TENSOR_CORE_KERNELS.get(name, ()):
        check(any(kernel in entry for entry in usage),
              f'{kernel} was not compiled')


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
    t0 = time.perf_counter()
    seconds = _build.build()
    for name in _build.KERNELS:
        report_build(name, seconds[name])
    g = torch.Generator(device='cuda').manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        sm.fused_gumbel_topk_sample(
            torch.randn(64, 8192, device='cuda', generator=g).to(dtype), 1.0,
            5, generator=g)
    torch.cuda.synchronize()
    log(f'build K1-K4 (nvcc in parallel + Triton first launch): '
        f'{time.perf_counter() - t0:.1f} s')

    results = {'K1': check_k1(g), 'K2': check_k2(g), 'K3': check_k3(g),
               'K4': check_k4(g)}
    torch.cuda.empty_cache()

    totals = {name: 0 for name in KERNEL_COUNTERS}
    stage1(totals)
    stage2(totals)
    torch.cuda.empty_cache()
    training(totals)
    for name, n in totals.items():
        check(n > 0, f'{name} never launched on the main path')

    meta = {
        'K1': ('flash_attention_fwd', 'cuda',
               'paintmind_tpu_torch/csrc/flash_attention.cu',
               'paintmind_tpu/ops/flash_attention.py:60'),
        'K2': ('vq_lookup_fwd', 'cuda', 'paintmind_tpu_torch/csrc/vq_lookup.cu',
               'paintmind_tpu/ops/vq_lookup.py:81'),
        'K3': ('fused_gumbel_topk_sample', 'triton',
               'paintmind_tpu_torch/ops/sampling.py',
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
