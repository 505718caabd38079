"""Device times of the hand-written VQ lookup (K2), sampling head (K3, a
warp a row), its radix-select kernel (K3r) and the routed FFN's grouped
expert products (K5: K5a and K5b apart, the dispatch and combine passes,
and the padded ``baddbmm`` pair they replace) through their
wrappers, for comparing two checkouts, or one checkout with and without a
part of a kernel, in one run on one card:

    python3 paintmind_tpu_torch/ops/kernel_times.py                # this checkout
    python3 paintmind_tpu_torch/ops/kernel_times.py --root DIR     # another one
    python3 paintmind_tpu_torch/ops/kernel_times.py --define K3_NO_SELECT
    python3 paintmind_tpu_torch/ops/kernel_times.py --root DIR --kernels K3r
    python3 paintmind_tpu_torch/ops/kernel_times.py --kernels K5
    python3 paintmind_tpu_torch/ops/kernel_times.py --kernels K1 K5e128

``--define`` compiles the kernels with a macro that cuts a part out
(``K3_NO_SELECT``: no top-k lists; ``K3_NO_EXP``: no exp and sum;
``K2_NO_FOLD``: no compare and select; ``K5_NO_EPILOGUE``: no bias, SwiGLU
or stores after a tile's products).  The results are then wrong; only
the time says what that part costs.  Launches are queued behind a device-side
sleep, so the time is the device's and not the host's rate of launching.

``K1`` and ``K5e128`` time sdar-30b-a3b's calls (a checkout before the
grouped-query K1 and the 128-expert K5 cannot run them): K1 over grouped
K/V read in place from the KV cache, beside SDPA on the repeated K/V, and
K5 at 128 bias-free experts of 768, beside the padded pair over the
buffer that dropless capacity gives it.
"""

import argparse
import subprocess
import sys
from pathlib import Path


ITERS = 100  # timed launches per figure


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--root', default=str(Path(__file__).resolve().parents[2]),
                        help='checkout whose paintmind_tpu_torch is timed')
    parser.add_argument('--define', action='append', default=[],
                        help='macro to compile the kernels with')
    parser.add_argument('--kernels', nargs='+', default=['K2', 'K3', 'K3r', 'K5'],
                        choices=['K1', 'K2', 'K3', 'K3r', 'K5', 'K5e128'],
                        help='kernels to time')
    args = parser.parse_args()
    sys.path[0] = args.root  # not this directory: its modules are the package's
    import torch
    from paintmind_tpu_torch.ops import _build
    from paintmind_tpu_torch.ops import sampling as sm
    from paintmind_tpu_torch.ops import vq_lookup as vq
    if not torch.cuda.is_available():
        sys.exit('kernel_times.py: no CUDA device available')
    _build.NVCC_FLAGS += tuple(f'-D{name}' for name in args.define)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f'{card}; {args.root}; defines {args.define or "none"}', flush=True)

    def device_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms: the queue fills behind it
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    g = torch.Generator(device='cuda').manual_seed(0)
    e = torch.nn.functional.normalize(
        torch.randn(8192, 32, device='cuda', generator=g), dim=-1)
    z = torch.nn.functional.normalize(
        torch.randn(8192, 32, device='cuda', generator=g), dim=-1)
    for t in (8192, 1024) if 'K2' in args.kernels else ():
        zt = z[:t].contiguous()
        ms = device_ms(lambda: vq.fused_nearest_codes(zt, e))
        print(f'K2 T={t} C=8192 D=32 fp32: {ms:.4f} ms = '
              f'{2 * t * 8192 * 32 / ms / 1e9:.2f} TFLOP/s', flush=True)
    logits = torch.randn(8192, 8192, device='cuda', generator=g) * 3
    runs = []  # k > 16 is K3r's in every checkout
    if 'K3' in args.kernels:
        runs += [('K3', what, lg, k) for what, lg in (
            ('bf16 T=8192', logits.bfloat16()), ('fp32 T=8192', logits),
            ('bf16 T=1024', logits[:1024].bfloat16())) for k in (5, 1)]
    if 'K3r' in args.kernels:
        runs += [('K3r', 'bf16 T=8192', logits.bfloat16(), k)
                 for k in (32, 17, 64, 256)]
        runs.append(('K3r', 'fp32 T=8192', logits, 32))
        # rows longer than 8192, which K3r reads again from memory
        runs += [('K3r', 'bf16 T=8192', (torch.randn(
            8192, v, device='cuda', generator=g) * 3).bfloat16(), 32)
            for v in (20000, 60000)]
    for name, what, lg, k in runs:
        ms = device_ms(lambda: sm.fused_gumbel_topk_sample(lg, 1.0, k, generator=g))
        print(f'{name} {what} V={lg.shape[-1]} k={k}: {ms:.4f} ms = '
              f'{lg.numel() * lg.element_size() / ms / 1e6:.0f} GB/s',
              flush=True)
    del logits
    if 'K5' in args.kernels:
        k5_times(device_ms, g)
    if 'K1' in args.kernels:
        k1_cache_times(device_ms, g)
    if 'K5e128' in args.kernels:
        k5_sdar_times(device_ms, g)


H100 = {'bf16': 989e12, 'bytes': 3.35e12}  # the data sheet's peaks at 700 W


def _bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / H100['bf16'] * 1e3, nbytes / H100['bytes'] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def k1_cache_times(device_ms, g):
    """K1 as sdar-30b-a3b's block passes call it at B = 64: 64 queries of
    32 heads over the first M rows of a (64, 1101, 4, 128) bf16 cache (4 KV
    heads), at the first block's M = 141 and the last one's M = 1101;
    SDPA on the same K/V repeated per query head and made contiguous."""
    import torch
    import torch.nn.functional as F
    from paintmind_tpu_torch.ops import flash_attention as fa
    b, n, h, hk, d, rows = 64, 64, 32, 4, 128, 1101
    q = torch.randn(b, n, h, d, device='cuda', generator=g).bfloat16()
    kc = torch.randn(b, rows, hk, d, device='cuda', generator=g).bfloat16()
    vc = torch.randn(b, rows, hk, d, device='cuda', generator=g).bfloat16()
    for m in (141, 1101):
        k, v = kc[:, :m], vc[:, :m]
        ms = device_ms(lambda: fa.flash_attention(q, k, v, d ** -0.5))
        kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kt, vt, scale=d ** -0.5))
        ops = 4 * b * h * n * m * d
        bms, by = _bound_ms(ops, (2 * b * n * h * d + 2 * b * m * hk * d) * 2)
        print(f'K1 sdar cache B={b} N={n} M={m} H={h} Hkv={hk} D={d}: '
              f'{ms:.4f} ms = {ops / ms / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms '
              f'({by}), SDPA on repeated K/V {lib:.4f} ms', flush=True)


def k5_sdar_times(device_ms, g):
    """K5 at sdar-30b-a3b's layer call: T = 4096 tokens (a block pass at
    B = 64), D = 2048, h = 768, 128 bias-free experts, top-8, dropless:
    32768 rows spread over the experts as a seeded multinomial draw of a
    token's 8 experts; the padded pair over the (128, 4096, 2048) buffer
    that capacity T gives it."""
    import torch
    from paintmind_tpu_torch.ops import moe_experts as me
    t, d, h, e, k = 4096, 2048, 768, 128, 8
    idx = torch.multinomial(torch.ones(t, e, device='cuda'), k, generator=g)
    counts = idx.reshape(-1).bincount(minlength=e)
    off = torch.nn.functional.pad(counts.cumsum(0), (1, 0)).int()
    rows = k * t
    xp = torch.randn(rows, d, device='cuda', generator=g).bfloat16()
    w12 = (torch.randn(e, 2 * h, d, device='cuda', generator=g) * 0.03).bfloat16()
    w3 = (torch.randn(e, d, h, device='cuda', generator=g) * 0.04).bfloat16()
    ms = device_ms(lambda: me.grouped_swiglu(xp, off, w12, None, w3, None))
    hit = int((counts > 0).sum())
    ops = 6 * d * h * rows
    bms, by = _bound_ms(ops, (hit * 3 * d * h + rows * (2 * d + 2 * h)) * 2)
    buf = torch.randn(e, t, d, device='cuda', generator=g).bfloat16()

    def padded():
        x1, x2 = torch.bmm(buf, w12.transpose(1, 2)).chunk(2, -1)
        return torch.bmm(torch.nn.functional.silu(x1) * x2, w3.transpose(1, 2))
    ms_pad = device_ms(padded)
    x = torch.randn(t, d, device='cuda', generator=g).bfloat16()
    flat = (torch.arange(e, device='cuda')[:, None] == idx.t().reshape(1, -1)).int()
    pos = ((flat.cumsum(1) - flat) * flat).sum(0).reshape(k, t).t()
    keep = torch.ones_like(pos, dtype=torch.bool)
    ms_disp = device_ms(lambda: me.dispatch(x, idx, pos, keep, t, e))
    print(f'K5 sdar T={t} rows={rows} E={e} ({hit} hit, {int(counts.min())}-'
          f'{int(counts.max())} rows an expert): {ms:.4f} ms = '
          f'{ops / ms / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms ({by}); the padded '
          f'pair over {e * t} slots {ms_pad:.4f} ms; dispatch {ms_disp:.4f} ms',
          flush=True)


def k5_times(device_ms, g):
    """K5 at the benchmark's layer call: T = 32768 tokens, D = 1024,
    h = 2736, E = 8, top-2, capacity 10240, 52 % of the 65536 assignments
    kept (``moe_fill.batch``), spread over the experts as a seeded
    multinomial draw."""
    import torch
    from paintmind_tpu_torch.ops import moe_experts as me
    t, d, h, e, cap = 32768, 1024, 2736, 8, 10240
    kept = round(0.52 * 2 * t)
    share = torch.rand(e, device='cuda', generator=g) + 0.5
    counts = torch.multinomial(share, kept, replacement=True,
                               generator=g).bincount(minlength=e).clamp(max=cap)
    off = torch.nn.functional.pad(counts.cumsum(0), (1, 0)).int()
    rows, rows_max = int(off[-1]), 2 * t
    x = torch.randn(t, d, device='cuda', generator=g).bfloat16()
    xp = x.repeat(2, 1)
    w12 = (torch.randn(e, 2 * h, d, device='cuda', generator=g) * 0.03).bfloat16()
    w3 = (torch.randn(e, d, h, device='cuda', generator=g) * 0.04).bfloat16()
    b12 = torch.zeros(e, 2 * h, device='cuda').bfloat16()
    b3 = torch.zeros(e, d, device='cuda').bfloat16()
    hid = torch.empty(rows_max, h, device='cuda', dtype=torch.bfloat16)
    out = torch.empty(rows_max, d, device='cuda', dtype=torch.bfloat16)
    flop = 2 * d * 2 * h * rows
    def k5(which):  # 1: K5a alone, 2: K5b alone
        me._launch('moe_experts', xp.data_ptr(), w12.data_ptr(), b12.data_ptr(),
                   w3.data_ptr(), b3.data_ptr(), off.data_ptr(), hid.data_ptr(),
                   out.data_ptr(), rows_max, d, h, e, which,
                   me._sm_count(xp.device), device=xp.device)
    ms_a = device_ms(lambda: k5(1))
    ms_b = device_ms(lambda: k5(2))
    print(f'K5 T={t} rows={rows} (counts {counts.tolist()}): K5a {ms_a:.4f} ms '
          f'= {flop / ms_a / 1e9:.1f} TFLOP/s, K5b {ms_b:.4f} ms = '
          f'{flop / 2 / ms_b / 1e9:.1f} TFLOP/s, both '
          f'{1.5 * flop / (ms_a + ms_b) / 1e9:.1f} TFLOP/s', flush=True)
    # a routing with the same shares: each token's two experts drawn from
    # them, queued slot-major as nn/moe.py's route() queues them
    idx = torch.multinomial(share.expand(t, e), 2, generator=g)
    flat = (torch.arange(e, device='cuda')[:, None] == idx.t().reshape(1, -1)).int()
    pos = ((flat.cumsum(1) - flat) * flat).sum(0).reshape(2, t).t()
    keep = pos < cap
    ms_disp = device_ms(lambda: me.dispatch(x, idx, pos, keep, cap, e))
    poff, row, _ = me.dispatch(x, idx, pos, keep, cap, e)
    gate = torch.rand(t, 2, device='cuda', generator=g).bfloat16()
    ms_comb = device_ms(lambda: me.combine(out, row, gate))
    buf = torch.randn(e, cap, d, device='cuda', generator=g).bfloat16()

    def padded():
        x1, x2 = torch.baddbmm(b12[:, None, :], buf, w12.transpose(1, 2)).chunk(2, -1)
        return torch.baddbmm(b3[:, None, :], torch.nn.functional.silu(x1) * x2,
                             w3.transpose(1, 2))
    ms_pad = device_ms(padded)
    print(f'K5 passes: dispatch {ms_disp:.4f} ms ({int(poff[-1])} rows), '
          f'combine {ms_comb:.4f} ms; the padded baddbmm pair '
          f'and SwiGLU over {e * cap} slots {ms_pad:.4f} ms', flush=True)


if __name__ == '__main__':
    main()
