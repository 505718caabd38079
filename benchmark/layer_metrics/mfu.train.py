"""mfu.train: model operations of the updates completed in the traced
window (``flops.train_update_flops``: forward and backward of the
transformer, the frozen encode's forward; an update whose text was dropped
counted with self-attention in place of cross-attention) over the window's
seconds times the card's bf16 peak, in %."""

import flops


def read(ctx):
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    peaks, c = ctx.peaks(), ctx.counters
    if peaks is None or not c.get('steps') or 'dropped' not in c:
        return None
    b = tr['batch'] * tr['grad_accum']
    total = ((c['steps'] - c['dropped'])
             * flops.train_update_flops(cfg, b, tr['context_len'], True)
             + c['dropped']
             * flops.train_update_flops(cfg, b, tr['context_len'], False))
    return 100.0 * total / (ctx.trace['window'] * peaks['bf16_flops'])
