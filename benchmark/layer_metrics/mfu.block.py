"""mfu.block: model operations of the block-diffusion ``generate`` calls
completed in the traced window (``flops_blocks.call_flops``: the prompt's
pass, each block's steps and commit pass, the decode) over the window's
seconds times the card's bf16 peak, in %."""

import flops_blocks


def read(ctx):
    calls, peaks = ctx.counters.get('calls'), ctx.peaks()
    if not calls or peaks is None:
        return None
    per = flops_blocks.call_flops(ctx.cell.config, ctx.cell.traffic)
    return 100.0 * calls * per / (ctx.trace['window'] * peaks['bf16_flops'])
