"""rope_roofline.block: kernel K6 (``csrc/rope.cu``: QK-norm and RoPE of q
and k in one pass) against its roofline: the summed bound time of the
window's K6 work (``flops_blocks.rope_calls``: every layer's q and k of
every pass, each element read and written once, on the memory's rate) over
the device time of K6's kernels in the trace, in %.  Nothing is read
without a K6 kernel in the trace."""

import flops_blocks

KERNEL = 'norm_rope_kernel'


def read(ctx):
    calls, peaks = ctx.counters.get('calls'), ctx.peaks()
    if not calls or peaks is None:
        return None
    busy = sum(s for name, s in ctx.trace['kernels'].items() if KERNEL in name)
    if busy <= 0:
        return None
    bound = calls * sum(
        n * flops_blocks.rope_bound_seconds(e, peaks)
        for n, e in flops_blocks.rope_calls(ctx.cell.config, ctx.cell.traffic))
    return 100.0 * bound / busy
