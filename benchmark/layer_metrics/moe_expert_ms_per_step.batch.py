"""moe_expert_ms_per_step.batch: device milliseconds of the routed FFN's
expert products (the program's ``pm.moe.experts`` spans: the two stacked
``baddbmm`` products and the SwiGLU between them) per sampler step, both
guided passes of every layer.  Read only when the span closed once per
routed call the window's steps imply."""

import spans


def read(ctx):
    n = spans.sampler_steps(ctx)
    dev = spans.device_s(ctx, spans.snapshot(), 'pm.moe.experts',
                         spans.routed_calls(ctx))
    return None if dev is None else 1e3 * dev / n
