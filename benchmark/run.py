"""One run of one benchmark cell, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers with their limits as the last lines of standard
error, and one JSON object as the last line of standard output.  Needs the
CUDA devices the cell asks for; exits non-zero without them.
"""

import time

T_IMPORT = time.time()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# caches of the program's libraries stay inside the checkout, at fixed paths
os.environ.setdefault('TORCH_EXTENSIONS_DIR', os.path.join(HERE, '.cache', 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(HERE, '.cache', 'triton'))
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(t_import=T_IMPORT))
