"""encode_ms_per_update.train: device milliseconds of the frozen VQGAN
encode (the program's ``pm.train.encode`` spans: the encoder and K2's
code lookup) per optimizer update.  Read only when ``pm.train.update``
closed once per update of the window and the encode once per microbatch."""

import spans


def read(ctx):
    n = spans.updates(ctx)
    snap = spans.snapshot()
    if spans.device_s(ctx, snap, 'pm.train.update', n) is None:
        return None
    micro = n * ctx.cell.traffic['grad_accum']
    dev = spans.device_s(ctx, snap, 'pm.train.encode', micro)
    return None if dev is None else 1e3 * dev / n
