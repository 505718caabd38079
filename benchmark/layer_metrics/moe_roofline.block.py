"""moe_roofline.block: kernel K5 (``csrc/moe_experts.cu``: K5a and K5b,
the grouped expert products) against its roofline: the summed bound time of
the window's routed calls (``flops_blocks.expert_bound_seconds``: 6 d h a
packed row on the bf16 peak, or each hit expert's weights and the rows'
bytes on the memory's, whichever bounds it) over the device time of K5's
kernels in the trace, in %.  The rows and the experts hit are the
program's counters (``pm.moe.rows``, ``pm.moe.experts_hit``, device sums
over the window, the graphs' replays included); the experts hit are
spread evenly over the calls.  Nothing is read when the routed calls (K5's
launches) or the rows disagree with the traffic's shapes (dropless: k rows
a token)."""

import flops_blocks
import spans

KERNEL = 'moe_expert_gemm'


def read(ctx):
    calls, peaks = ctx.counters.get('calls'), ctx.peaks()
    snap = spans.snapshot()
    if not calls or peaks is None or snap is None:
        return None
    cfg = ctx.cell.config
    k = cfg['pipeline']['num_selected']
    plan = [(calls * n, t * k) for n, t in
            flops_blocks.routed_calls(cfg, ctx.cell.traffic)]
    count = sum(n for n, _ in plan)
    rows = snap['counters'].get('pm.moe.rows')
    hit = snap['counters'].get('pm.moe.experts_hit')
    if (ctx.counters['launches'].get('K5') != count
            or rows is None or hit is None
            or int(rows) != sum(n * r for n, r in plan)):
        return None
    per_call_hit = float(hit) / count
    bound = sum(n * flops_blocks.expert_bound_seconds(cfg, r, per_call_hit,
                                                      peaks)
                for n, r in plan)
    busy = sum(s for name, s in ctx.trace['kernels'].items() if KERNEL in name)
    return 100.0 * bound / busy if busy > 0 else None
