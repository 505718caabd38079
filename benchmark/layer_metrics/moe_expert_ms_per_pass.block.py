"""moe_expert_ms_per_pass.block: device milliseconds of the routed FFN's
expert products (kernel K5, ``csrc/moe_experts.cu``: K5a and K5b, their
rows in the trace) per transformer pass of the block-diffusion calls (the
prompt's pass, each block's steps and its commit pass), all of the stack's
layers.  Read only when K5 launched once per layer of every pass the
window's calls imply (the launches of the graphs' replays included)."""

import flops_blocks

KERNEL = 'moe_expert_gemm'


def read(ctx):
    calls = ctx.counters.get('calls')
    if not calls or ctx.device['platform'] != 'gpu':
        return None
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    n = calls * flops_blocks.passes(cfg, tr)
    if ctx.counters['launches'].get('K5') != n * cfg['pipeline']['depth']:
        return None
    busy = sum(s for name, s in ctx.trace['kernels'].items() if KERNEL in name)
    return 1e3 * busy / n if busy > 0 else None
