"""The rate sweep that finds a serving cell's knee (not part of a run):

    python3 benchmark/sweep.py --workload <cell> --seconds 51 --rates 2.4 2.8 ... \
        [--config paintmindv1 --traffic http_poisson]

One process; for each rate, the cell's set-up and one window at that rate
(the traffic file's other parameters unchanged), then one JSON line: the
latency quartiles and the mean backlog (requests due and not yet answered,
sampled at each arrival) over the window's thirds.  The knee is the highest
rate whose backlog does not grow from the second third to the last; the
cell's rate is set at 0.8 of it in its traffic file.  A cell that
``BENCHMARK.json`` does not list yet is named with its configuration and
traffic (its ``cells/<cell>.json`` must exist).
"""

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ['USE_FLAX'] = '0'

import numpy as np  # noqa: E402

import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--rates', type=float, nargs='+', required=True)
    ap.add_argument('--seed', type=int, default=7100)
    ap.add_argument('--config')
    ap.add_argument('--traffic')
    args = ap.parse_args()
    import torch
    bench = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    if args.config:
        bench['workloads'].append({'name': args.workload, 'config': args.config,
                                   'traffic': args.traffic, 'chips': 1})
    cell = harness.resolve(args.workload, bench)
    gen = cell.generator()
    for i, rate in enumerate(args.rates):
        cell.traffic['rate'] = rate
        s = gen.setup(harness.Run(cell=cell, seed=args.seed + i,
                                  device='cuda'))
        st = gen.window(s, args.seconds)
        ok = [r for r in st['requests'] if r['status'] == 200]
        due = np.array([r['due'] for r in ok])
        done = np.array([r['done'] for r in ok])
        lat = done - due
        backlog = np.array([((due <= t) & (done > t)).sum() for t in due])
        third = args.seconds / 3
        parts = [(due >= k * third) & (due < (k + 1) * third) for k in range(3)]
        print(json.dumps({
            'rate': rate, 'requests': len(st['requests']), 'answered': len(ok),
            'p50': float(np.percentile(lat, 50)),
            'p90': float(np.percentile(lat, 90)),
            'p95': float(np.percentile(lat, 95)),
            'backlog_thirds': [float(backlog[p].mean()) for p in parts],
            'p50_thirds': [float(np.median(lat[p])) for p in parts],
            'batches': st['engine']['batches'],
            'padded_slots': st['engine']['padded_slots']}), flush=True)
        gen.release(s)
        del s
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
