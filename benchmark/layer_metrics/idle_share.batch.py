"""idle_share.batch: the share of the traced window in which no operation
ran on the device (the union of the trace's kernels, copies and sets),
in %."""


def read(ctx):
    w = ctx.trace['window']
    if ctx.device['platform'] != 'gpu' or w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace['busy_s'] / w)
