"""sampler_ms_per_step.block: device milliseconds of the sampling head per
denoising step of the block-diffusion calls: the program's ``pm.step.draw``
(K3, the Gumbel top-k draw over a block's logits) and ``pm.step.remask``
(the block's confidence re-mask) spans, which run outside the stack's
graphs.  Read only when each closed once per step of the window's calls
(blocks × ``block_steps`` a call)."""

import spans


def read(ctx):
    calls = ctx.counters.get('calls')
    if not calls:
        return None
    p, s1 = ctx.cell.config['pipeline'], ctx.cell.config['stage1']['enc']
    blocks = (s1['image_size'] // s1['patch_size']) ** 2 // p['block_len']
    n = calls * blocks * p['block_steps']
    snap = spans.snapshot()
    draw = spans.device_s(ctx, snap, 'pm.step.draw', n)
    remask = spans.device_s(ctx, snap, 'pm.step.remask', n)
    if draw is None or remask is None:
        return None
    return 1e3 * (draw + remask) / n
