"""attn_bwd_roofline.train: kernel K4 (``csrc/flash_attention_bwd.cu``)
against its roofline: the summed bound time of the window's K4 calls (each
call's operations, 10 b h n m d, or bytes, whichever bounds it, from the
shapes of the updates: ``flops.train_attention_calls``) over the device
time of K4's kernels in the trace, in %.  Nothing is read when the
program's K4 launch counter disagrees with the calls those shapes imply."""

import flops

KERNEL = 'attn_bwd_'


def read(ctx):
    tr, cfg, c = ctx.cell.traffic, ctx.cell.config, ctx.counters
    peaks = ctx.peaks()
    if peaks is None or not c.get('steps') or 'dropped' not in c:
        return None
    b = tr['batch'] * tr['grad_accum']
    plan = [(c['steps'] - c['dropped'], True), (c['dropped'], False)]
    calls = [(k * n, shape) for k, text in plan for n, *shape in
             flops.train_attention_calls(cfg, b, tr['context_len'], text)]
    if c['launches'].get('K4') != sum(n for n, _ in calls):
        return None
    bound = sum(n * flops.bound_seconds(*flops.attention_cost(
        *shape, backward=True), peaks) for n, shape in calls)
    busy = sum(s for name, s in ctx.trace['kernels'].items() if KERNEL in name)
    return 100.0 * bound / busy if busy > 0 else None
