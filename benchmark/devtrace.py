"""The reduction of a ``torch.profiler`` trace to what the metrics read.

The traced run records host and device activity; the harness writes the
profiler's Chrome trace to a temporary file, and ``reduce`` keeps:

* ``window``: the host interval of the ``bench.window`` range (seconds);
* ``busy_s``: the union of device operations (kernels, copies, sets)
  inside the window;
* ``kernels``: device seconds by operation name inside the window;
* ``ranges``: for each ``bench.*`` range name other than the window, the
  device seconds of the operations launched from inside its instances;
* ``gaps``: the device's idle gaps inside the window, each labelled by
  the innermost host operation under way on the launching thread.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(path, window_name='bench.window'):
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    wins = [e for e in spans if e.get('name') == window_name
            and e.get('cat') == 'user_annotation']
    if not wins:
        raise RuntimeError(f'trace has no {window_name!r} range')
    w0 = float(wins[0]['ts'])
    w1 = w0 + float(wins[0]['dur'])
    dev = [e for e in spans if e.get('cat') in DEVICE_CATS]
    launch = {}
    host = defaultdict(list)
    for e in spans:
        cat = e.get('cat')
        if cat in HOST_CATS:
            host[e.get('tid')].append(e)
            corr = (e.get('args') or {}).get('correlation')
            if cat in ('cuda_runtime', 'cuda_driver') and corr is not None:
                launch[corr] = e
    kernels = defaultdict(float)
    clipped = []
    for e in dev:
        a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[e['name']] += (b - a) * 1e-6
        clipped.append((a, b, e))
    busy = _union([(a, b) for a, b, _ in clipped])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    # device time of the operations launched inside each bench.* range
    named = defaultdict(list)
    for tid, evs in host.items():
        for e in evs:
            n = e.get('name', '')
            if e.get('cat') == 'user_annotation' and n.startswith('bench.') \
                    and n != window_name:
                named[n].append((tid, float(e['ts']),
                                 float(e['ts']) + float(e['dur'])))
    ranges = {}
    for n, ivs in named.items():
        by_tid = defaultdict(list)
        for tid, a, b in ivs:
            by_tid[tid].append((a, b))
        for tid in by_tid:
            by_tid[tid].sort()
        total = 0.0
        for a, b, e in clipped:
            src = launch.get((e.get('args') or {}).get('correlation'))
            if src is None:
                continue
            lst = by_tid.get(src.get('tid'), ())
            t = float(src['ts'])
            i = bisect.bisect_right(lst, (t, float('inf'))) - 1
            if i >= 0 and lst[i][0] <= t <= lst[i][1]:
                total += (b - a) * 1e-6
        ranges[n] = total

    # idle gaps, labelled by the host operation under way when they end
    host_starts = {}
    for tid, evs in host.items():
        evs.sort(key=lambda e: float(e['ts']))
        host_starts[tid] = [float(e['ts']) for e in evs]
    gaps = []
    edges = [[w0, w0]] + busy + [[w1, w1]]
    starts = sorted(((a, e) for a, b, e in clipped), key=lambda x: x[0])
    keys = [s for s, _ in starts]
    for (_, end), (nxt, _) in zip(edges[:-1], edges[1:]):
        if nxt - end <= 0:
            continue
        label = 'host: none'
        j = bisect.bisect_left(keys, nxt)
        if j < len(starts):
            src = launch.get((starts[j][1].get('args') or {}).get('correlation'))
            if src is not None:
                tid = src.get('tid')
                label = _innermost(host[tid], (end + nxt) / 2,
                                   host_starts[tid])
        gaps.append(((nxt - end) * 1e-6, label))
    return {'window': (w1 - w0) * 1e-6, 'busy_s': busy_s,
            'kernels': dict(kernels), 'ranges': ranges, 'gaps': gaps}


def _innermost(evs, t, starts, look=256):
    """The shortest host event of ``evs`` (sorted by ``starts``) that
    covers ``t``, among the ``look`` that started last before it."""
    i = bisect.bisect_right(starts, t)
    best = None
    for e in evs[max(0, i - look):i]:
        if float(e['ts']) + float(e['dur']) >= t and (
                best is None or float(e['dur']) < float(best['dur'])):
            best = e
    return best['name'] if best is not None else 'host: none'


def breakdown(red, top=10):
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing, each at most ``top`` entries."""
    ops = sorted(red['kernels'].items(), key=lambda kv: -kv[1])[:top]
    idle = defaultdict(float)
    for s, label in red['gaps']:
        idle[label] += s
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[n, s] for n, s in ops],
            'idle_gaps': [[n, s] for n, s in gaps]}
