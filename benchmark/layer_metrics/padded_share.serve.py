"""padded_share.serve: the engine's padded slots over all the slots its
batches ran in the window (``padded_slots / (padded_slots +
batched_requests)``, the engine's own counters), in %."""


def read(ctx):
    pad = ctx.counters.get('padded_slots')
    used = ctx.counters.get('batched_requests')
    if pad is None or not used:
        return None
    return 100.0 * pad / (pad + used)
