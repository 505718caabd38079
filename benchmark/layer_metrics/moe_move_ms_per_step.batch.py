"""moe_move_ms_per_step.batch: device milliseconds of the routed FFN
outside its expert products per sampler step: the program's ``pm.moe``
spans less their ``pm.moe.experts`` children (routing, the slot-major
queue, the dispatch scatter, the combine's gather and product, the routing
statistics, and the glue between them).  Read only when both spans closed
once per routed call the window's steps imply."""

import spans


def read(ctx):
    n, calls = spans.sampler_steps(ctx), spans.routed_calls(ctx)
    snap = spans.snapshot()
    whole = spans.device_s(ctx, snap, 'pm.moe', calls)
    experts = spans.device_s(ctx, snap, 'pm.moe.experts', calls)
    if whole is None or experts is None:
        return None
    return 1e3 * (whole - experts) / n
