"""Device times of the hand-written VQ lookup (K2), sampling head (K3, a
warp a row) and its radix-select kernel (K3r) through their wrappers, for
comparing two checkouts, or one checkout with and without a part of a
kernel, in one run on one card:

    python3 paintmind_tpu_torch/ops/kernel_times.py                # this checkout
    python3 paintmind_tpu_torch/ops/kernel_times.py --root DIR     # another one
    python3 paintmind_tpu_torch/ops/kernel_times.py --define K3_NO_SELECT
    python3 paintmind_tpu_torch/ops/kernel_times.py --root DIR --kernels K3r

``--define`` compiles the kernels with a macro that cuts a part out
(``K3_NO_SELECT``: no top-k lists; ``K3_NO_EXP``: no exp and sum;
``K2_NO_FOLD``: no compare and select).  The results are then wrong; only
the time says what that part costs.  Launches are queued behind a device-side
sleep, so the time is the device's and not the host's rate of launching.
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
    parser.add_argument('--kernels', nargs='+', default=['K2', 'K3', 'K3r'],
                        choices=['K2', 'K3', 'K3r'], help='kernels to time')
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


if __name__ == '__main__':
    main()
