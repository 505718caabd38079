"""optim_ms_per_update.train: device milliseconds of the optimizer phase
per update (the program's ``pm.train.optimizer`` spans: the gradients'
mean, global-norm clipping and Lion).  The span's events measure the
interval on the stream, so it holds Lion's kernels and the idle their
launches leave.  Read only when it closed once per update of the window."""

import spans


def read(ctx):
    n = spans.updates(ctx)
    dev = spans.device_s(ctx, spans.snapshot(), 'pm.train.optimizer', n)
    return None if dev is None else 1e3 * dev / n
