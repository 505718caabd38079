"""moe_ms_per_step.batch: device milliseconds of the operations launched
inside the benchmark's ``bench.moe`` ranges (entered and left by forward
hooks on each routed FFN module) per sampler step: router, queue,
dispatch, experts and combine of both guided passes of every layer."""


def read(ctx):
    dev = ctx.trace['ranges'].get('bench.moe')
    calls = ctx.counters.get('calls')
    if not dev or not calls:
        return None
    return 1e3 * dev / (calls * ctx.cell.traffic['timesteps'])
