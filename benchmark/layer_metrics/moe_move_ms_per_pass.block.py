"""moe_move_ms_per_pass.block: device milliseconds per transformer pass of
the block-diffusion calls (all of the stack's layers) of the routed FFN's
work outside its expert products, read from the trace's kernel rows (the
stack's passes replay as CUDA graphs, inside which the ``pm.moe`` spans do
not record): the kernels that in this cell's calls only the routing, the
dispatch and the combine launch, matched by ``KERNELS`` (the fp32 router
GEMM, the softmax over the experts, the top-k's sort, the queue's scan,
K5's count, dispatch and combine).  The elementwise and reduction glue
between them (one-hot, casts, gate sums; a third of the non-expert time in
an eager profile) shares its kernels with the rest of the call and is not
counted.  Read only when K5 launched once per layer of every pass and each
of ``KERNELS`` is in the trace: a kernel renamed or replaced reads nothing
rather than less."""

import flops_blocks

KERNELS = ('sm80_xmma_gemm_f32f32', 'softmax_warp_forward<float, float, float',
           'radixSortKVInPlace', 'tensor_kernel_scan_innermost_dim<int',
           'moe_count_kernel', 'moe_dispatch_kernel', 'moe_combine_kernel')


def read(ctx):
    calls = ctx.counters.get('calls')
    if not calls or ctx.device['platform'] != 'gpu':
        return None
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    n = calls * flops_blocks.passes(cfg, tr)
    if ctx.counters['launches'].get('K5') != n * cfg['pipeline']['depth']:
        return None
    total = 0.0
    for key in KERNELS:
        part = sum(s for name, s in ctx.trace['kernels'].items() if key in name)
        if part <= 0:
            return None
        total += part
    return 1e3 * total / n
