"""The readings that a cell's limits are set from, several seeds in one
process (not part of a benchmark run):

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --mode none|program|reference --seeds <n> [<n> ...]

``none``: the program as the cell runs it (the lower readings).
``program``: for each seed a sound run, then the program's own lower-
precision path (``Pipeline.quantize('w8a8')``) as the control.
``reference``: sound runs whose check also reads the reference computed
in fp8 (``check.CONTROL``) in the program's place (``<number>.control``).
Prints one JSON line a run: seed, mode, the compared numbers and the
diagnostics; ``--out`` appends them to a file as well.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ['USE_FLAX'] = '0'

import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--mode', choices=('none', 'program', 'reference'),
                    required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--out')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('control readings are taken on the card', file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    modes = {'none': [None], 'program': [None, 'program'],
             'reference': ['reference']}[args.mode]
    for seed in args.seeds:
        for mode in modes:
            t0 = time.time()
            res, _ = harness.run_cell(cell, seed, args.seconds, 0, 'cuda', t0,
                                      control=mode)
            line = json.dumps({'workload': args.workload, 'seed': seed,
                               'control': mode, 'correct': res['correct'],
                               'metrics': res['metrics'],
                               'diagnostics': res['diagnostics'],
                               'compared': res['compared'],
                               'seconds': time.time() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, 'a') as f:
                    f.write(line + '\n')
            del res
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
