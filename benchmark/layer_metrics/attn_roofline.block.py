"""attn_roofline.block: kernel K1 (``csrc/flash_attention.cu``, grouped
K/V read in place from the KV cache) against its roofline: the summed bound
time of the window's K1 calls (each call's operations or bytes, whichever
bounds it: ``flops_blocks.attention_calls`` and ``attention_cost``, K and V
read once a KV head) over the device time of K1's kernels in the trace, in
%.  Nothing is read when the program's counters disagree with those
shapes: its K1 launches, or the operations it counted (``pm.attn.ops``)."""

import flops_blocks
import spans

KERNEL = 'attn_fwd_'


def read(ctx):
    calls, peaks = ctx.counters.get('calls'), ctx.peaks()
    snap = spans.snapshot()
    if not calls or peaks is None or snap is None:
        return None
    shapes = flops_blocks.attention_calls(ctx.cell.config, ctx.cell.traffic)
    costs = [(n, flops_blocks.attention_cost(*shape)) for n, *shape in shapes]
    if (ctx.counters['launches'].get('K1') != calls * sum(n for n, _ in costs)
            or snap['counters'].get('pm.attn.ops')
            != calls * sum(n * ops for n, (ops, _) in costs)):
        return None
    bound = calls * sum(n * max(ops / peaks['bf16_flops'],
                                nbytes / peaks['hbm_bytes_per_s'])
                        for n, (ops, nbytes) in costs)
    busy = sum(s for name, s in ctx.trace['kernels'].items() if KERNEL in name)
    return 100.0 * bound / busy if busy > 0 else None
