"""moe_fill.batch: the share of the routed (token, slot) assignments that
found room in their expert's capacity over the window, in % (the program's
counters ``pm.moe.kept``, a device sum of the routing's keep mask, over
``pm.moe.assignments``).  Read only on a card, and when the ``pm.moe``
span closed once per routed call the window's steps imply."""

import spans


def read(ctx):
    snap = spans.snapshot()
    if spans.device_s(ctx, snap, 'pm.moe', spans.routed_calls(ctx)) is None:
        return None
    kept = snap['counters'].get('pm.moe.kept')
    total = snap['counters'].get('pm.moe.assignments')
    if kept is None or not total:
        return None
    return 100.0 * kept / total
