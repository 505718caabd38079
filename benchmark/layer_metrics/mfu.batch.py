"""mfu.batch: model operations of the ``generate`` calls completed in the
traced window (``flops.generate_flops``, routed slots counted as filled by
the routing's own dropped share) over the window's seconds times the
card's bf16 peak, in %."""

import flops


def read(ctx):
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    calls, peaks = ctx.counters.get('calls'), ctx.peaks()
    if not calls or peaks is None:
        return None
    per = flops.generate_flops(cfg, tr['batch'], tr['timesteps'],
                               tr['context_len'], ctx.counters['guided'],
                               ctx.counters.get('filled', 1.0))
    return 100.0 * calls * per / (ctx.trace['window'] * peaks['bf16_flops'])
