"""The program's own spans and counters (``paintmind_tpu_torch.utils.
profiling``) as the per-layer readers see them.  The port records them
while a ``torch.profiler`` session records, which in a run is the traced
window alone, so its ``snapshot()`` after the window holds the window's
spans: per name the count and the host and device seconds (device: the
interval of a pair of CUDA events around the span), and the counters.

A reader reads nothing (None) off a card, where the program has no spans
(a checkout before them), where a span it needs is missing, or where a
span's count disagrees with what the generator's counters imply."""

from __future__ import annotations


def snapshot():
    """The program's snapshot, or None where it keeps no spans."""
    try:
        from paintmind_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, 'snapshot', None)
    return None if snap is None else snap()


def device_s(ctx, snap, name, count):
    """Device seconds of the span ``name``, None off a card, without the
    span, or when it closed another number of times than ``count``."""
    if ctx.device['platform'] != 'gpu' or snap is None or not count:
        return None
    span = snap['spans'].get(name)
    if span is None or span['count'] != count:
        return None
    return span['device_s']


def sampler_steps(ctx):
    """Sampler steps of the window's ``generate`` calls (calls × timesteps
    by the generator's counters)."""
    calls = ctx.counters.get('calls')
    return calls * ctx.cell.traffic['timesteps'] if calls else None


def routed_calls(ctx):
    """Routed FFN calls of the window: a step runs every layer once per
    pass, two passes when guided."""
    steps = sampler_steps(ctx)
    pipe = ctx.cell.config['pipeline']
    if not steps or not pipe.get('num_experts'):
        return None
    passes = 2 if ctx.counters.get('guided') else 1
    return steps * passes * pipe['depth']


def updates(ctx):
    """Optimizer updates of the window (the generator's counter)."""
    return ctx.counters.get('steps') or None
