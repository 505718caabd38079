"""sampler_ms_per_step.batch: device milliseconds of the sampling head per
sampler step: the program's ``pm.step.draw`` (K3 / K3r, the Gumbel top-k
draw over the guided logits) and ``pm.step.remask`` (the confidence
re-mask) spans.  Read only when each closed once per step of the window's
calls."""

import spans


def read(ctx):
    n = spans.sampler_steps(ctx)
    snap = spans.snapshot()
    draw = spans.device_s(ctx, snap, 'pm.step.draw', n)
    remask = spans.device_s(ctx, snap, 'pm.step.remask', n)
    if draw is None or remask is None:
        return None
    return 1e3 * (draw + remask) / n
