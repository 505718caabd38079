"""attn_roofline.batch: kernel K1 (``csrc/flash_attention.cu``) against its
roofline: the summed bound time of the window's K1 calls (each call's
operations or bytes, whichever bounds it, from the shapes the traffic
gives) over the device time of K1's kernels in the trace, in %.  Nothing
is read when the program's K1 launch counter disagrees with the calls
those shapes imply, or when the trace shows no K1 kernel."""

import flops

KERNEL = 'attn_fwd_'


def read(ctx):
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    calls = ctx.counters.get('calls')
    shapes = flops.generate_attention_calls(
        cfg, tr['batch'], tr['timesteps'], tr['context_len'],
        ctx.counters.get('guided', False))
    peaks = ctx.peaks()
    if not calls or peaks is None or ctx.counters['launches'].get(
            'K1') != calls * sum(n for n, *_ in shapes):
        return None
    bound = calls * sum(n * flops.bound_seconds(*flops.attention_cost(*shape),
                                                peaks)
                        for n, *shape in shapes)
    busy = sum(s for name, s in ctx.trace['kernels'].items() if KERNEL in name)
    return 100.0 * bound / busy if busy > 0 else None
