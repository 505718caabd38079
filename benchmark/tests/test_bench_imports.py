"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference loads nothing of the port."""

import os
import subprocess
import sys

from conftest import BENCH, ROOT

RUN_TINY = f'''
import sys, tempfile, time
sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.join(BENCH, 'tests')!r}]
from conftest import add_tiny_cell
import harness
cell = add_tiny_cell(tempfile.mkdtemp(), 'imports_cell')
res, _ = harness.run_cell(cell, 5, 0.5, 0, 'cpu', time.time())
assert res['correct'], res
top = {{m.split('.')[0] for m in sys.modules}}
print(sorted(top & {{'jax', 'jaxlib', 'flax', 'paintmind_tpu'}}))
print('paintmind_tpu_torch' in top)
'''

REF_ONLY = f'''
import sys
sys.path[:0] = [{BENCH!r}]
from reference import model
import check, flops, peaks, devtrace, weights
top = {{m.split('.')[0] for m in sys.modules}}
print(sorted(t for t in top if t.startswith('paintmind')))
'''


def _run(code):
    env = dict(os.environ, USE_FLAX='0')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.split('\n')


def test_a_run_loads_no_jax():
    lines = _run(RUN_TINY)
    assert lines[-3] == '[]'
    assert lines[-2] == 'True'          # the port itself was measured


def test_reference_loads_nothing_of_the_port():
    assert _run(REF_ONLY)[-2] == '[]'


def test_forbidden_names_compared_whole():
    import harness
    before = dict(sys.modules)
    try:
        sys.modules['paintmind_tpu_torch_x'] = sys
        assert 'paintmind_tpu' not in harness.forbidden_modules()
        sys.modules['paintmind_tpu.sub'] = sys
        assert 'paintmind_tpu' in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
