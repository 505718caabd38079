"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name:

* ``configs/<file>``        the configuration (named in BENCHMARK.json);
* ``traffic/<traffic>.json`` the traffic mix; its ``generator`` key names
  ``generators/<generator>.py``, the one generator of that kind of traffic;
* ``cells/<cell>.json``     the cell's check: what is compared, its limits;
* ``layer_metrics/<metric>.py`` a reader with ``read(ctx)`` that returns
  the metric's value, or None where it finds nothing to read.

A generator module has ``setup(run) -> state``, ``window(state, seconds) ->
stats``, ``release(state)``, ``check(state, stats) -> [(name, value,
limit)]`` and ``end_to_end(state, stats) -> {metric: value}``; with
``--trace 1`` its ``trace_hooks(state)`` and ``counters(state, stats)``
feed the readers.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'paintmind_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def import_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    check: dict
    bench: dict
    base: str

    def generator(self):
        kind = self.traffic['generator']
        return import_file(os.path.join(self.base, 'generators', kind + '.py'),
                           f'bench_generator_{kind}')

    def end_to_end(self):
        """The cell's end-to-end metric entries."""
        return [m for m in self.bench['end_to_end']
                if 'workloads' not in m or self.name in m['workloads']]

    def per_layer(self):
        """The cell's per-layer metric entries: those that list it, and
        those without a list whose ``moves`` metric the cell reports."""
        mine = {m['name'] for m in self.end_to_end()}
        return [m for m in self.bench['per_layer']
                if (self.name in m['workloads'] if 'workloads' in m
                    else m['moves'] in mine)]


def resolve(name, bench=None, root=ROOT, base=HERE):
    """The cell ``name`` of ``bench`` (``root``/BENCHMARK.json by default),
    with its files read from ``base``."""
    if bench is None:
        bench = load_json(os.path.join(root, 'BENCHMARK.json'))
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    w = work[name]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    return Cell(name=name, workload=w,
                config=load_json(os.path.join(root, conf['file'])),
                traffic=load_json(os.path.join(base, 'traffic',
                                               w['traffic'] + '.json')),
                check=load_json(os.path.join(base, 'cells', name + '.json')),
                bench=bench, base=base)


@dataclasses.dataclass
class Run:
    """What a generator's set-up gets."""
    cell: Cell
    seed: int
    device: str
    control: str | None = None  # 'program' | 'reference': see control.py

    def rng_seed(self, *salt):
        """A 63-bit seed derived from the run's seed and ``salt``."""
        import hashlib
        h = hashlib.sha256(repr((self.seed,) + salt).encode()).digest()
        return int.from_bytes(h[:8], 'little') >> 1


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, device, count):
    if device == 'cpu':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count,
            'memory_peak_bytes': max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def run_cell(cell, seed, seconds, trace, device, t_start, control=None):
    """One run; returns (result dict, compared numbers)."""
    import torch
    gen = cell.generator()
    state = gen.setup(Run(cell=cell, seed=int(seed), device=device,
                          control=control))
    setup_s = time.time() - t_start
    print(f'set-up {setup_s:.3f} s', file=sys.stderr, flush=True)
    prof = hooks = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device != 'cpu':
            acts.append(ProfilerActivity.CUDA)
        hooks = gen.trace_hooks(state)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function('bench.window'):
            stats = gen.window(state, seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            for h in hooks:
                h.remove()
    print(f'window {stats["seconds"]:.3f} s', file=sys.stderr, flush=True)
    count = int(cell.workload.get('chips', 1))
    dev = device_info(torch, device, count)
    red = None
    if prof is not None:
        import tempfile
        from devtrace import reduce
        fd, tmp = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(tmp)
            del prof
            red = reduce(tmp)
        finally:
            os.unlink(tmp)
        dev['busy_s'] = red['busy_s']
        dev['window_s'] = red['window']
    counters = gen.counters(state, stats) if trace else {}
    gen.release(state)
    t_check = time.time()
    numbers = gen.check(state, stats)
    t_check = time.time() - t_check
    correct = all(_within(v, lim) for _, v, lim in numbers)
    if trace:
        metrics = layer_metrics(cell, red, counters, dev)
    else:
        e2e = gen.end_to_end(state, stats)
        e2e['setup_s'] = setup_s
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end()}
    result = {'correct': bool(correct), 'attempted': stats['attempted'],
              'failed': stats['failed'], 'metrics': metrics, 'device': dev}
    if red is not None:
        from devtrace import breakdown
        result['breakdown'] = breakdown(red)
    result['diagnostics'] = dict(getattr(state, 'diagnostics', {}),
                                 check_s=t_check, counters=counters,
                                 call_s=getattr(state, 'call_s', None))
    result['compared'] = {n: {'value': v, 'limit': lim} for n, v, lim in numbers}
    return result, numbers


def _within(value, limit):
    return (value is not None and limit is not None and not math.isnan(value)
            and value <= limit)


@dataclasses.dataclass
class ReaderContext:
    """What a per-layer reader sees."""
    cell: Cell
    trace: dict
    counters: dict
    device: dict

    def peaks(self):
        """The card's table of peaks; None off a card (no device metric
        is read from a CPU run)."""
        if self.device['platform'] != 'gpu':
            return None
        from peaks import for_device
        return for_device(self.device['kind'])


def layer_metrics(cell, red, counters, dev):
    ctx = ReaderContext(cell=cell, trace=red, counters=counters, device=dev)
    out = {}
    for m in cell.per_layer():
        mod = import_file(os.path.join(cell.base, 'layer_metrics',
                                       m['name'] + '.py'),
                          'bench_metric_' + m['name'].replace('.', '_'))
        value = mod.read(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def process_start_time():
    """Wall-clock time this process started (Linux), else None."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith('btime'))
        return boot + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, StopIteration):
        return None


def main(argv=None, t_import=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start_time() or t_import or time.time()
    cell = resolve(args.workload)
    import torch
    want = int(cell.workload.get('chips', 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f'{args.workload} needs {want} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, numbers = run_cell(cell, args.seed, args.seconds, args.trace,
                               'cuda', start)
    bad = forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 3
    for n, v, lim in numbers:
        print(f'check {n} = {v!r} (limit {lim!r})', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
