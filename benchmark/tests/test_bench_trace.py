"""The trace reduction and the per-layer readers on a made-up trace."""

import json
import os

import devtrace
import harness
import pytest
from conftest import BENCH


def _trace(tmp_path):
    ev = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.window', 'ts': 0,
         'dur': 1000, 'tid': 1},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.moe', 'ts': 100,
         'dur': 100, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'ts': 90, 'dur': 30,
         'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::nonzero', 'ts': 500,
         'dur': 200, 'tid': 1},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 110,
         'dur': 5, 'tid': 1, 'args': {'correlation': 1}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 300,
         'dur': 5, 'tid': 1, 'args': {'correlation': 2}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 650,
         'dur': 5, 'tid': 1, 'args': {'correlation': 3}},
        # kernels: 150-350 (moe range launch), 300-400 overlaps, 800-900
        {'ph': 'X', 'cat': 'kernel', 'name': 'attn_fwd_wgmma<64>', 'ts': 150,
         'dur': 200, 'tid': 7, 'args': {'correlation': 1}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'gemm', 'ts': 300, 'dur': 100,
         'tid': 7, 'args': {'correlation': 2}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'gemm', 'ts': 800, 'dur': 100,
         'tid': 7, 'args': {'correlation': 3}},
    ]
    path = os.path.join(str(tmp_path), 't.json')
    with open(path, 'w') as f:
        json.dump({'traceEvents': ev}, f)
    return devtrace.reduce(path)


def test_reduce(tmp_path):
    red = _trace(tmp_path)
    assert red['window'] == pytest.approx(1e-3)
    assert red['busy_s'] == pytest.approx(350e-6)       # 150-400, 800-900
    assert red['kernels']['gemm'] == pytest.approx(200e-6)
    assert red['ranges']['bench.moe'] == pytest.approx(200e-6)
    gaps = dict((label, s) for s, label in red['gaps'])
    assert gaps['aten::nonzero'] == pytest.approx(400e-6)   # 400-800
    bd = devtrace.breakdown(red)
    assert bd['device_ops'][0][0] == 'attn_fwd_wgmma<64>'


def test_readers(tmp_path):
    red = _trace(tmp_path)
    cell = harness.resolve('moe_lb_t2i_b64')
    dev = {'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3'}
    ctx = harness.ReaderContext(cell=cell, trace=red, device=dev,
                                counters={'calls': 1, 'guided': True,
                                          'launches': {'K1': 1}})
    mod = lambda n: harness.import_file(  # noqa: E731
        os.path.join(BENCH, 'layer_metrics', n + '.py'), n.replace('.', '_'))
    assert mod('idle_share.batch').read(ctx) == pytest.approx(65.0)
    assert mod('moe_ms_per_step.batch').read(ctx) == pytest.approx(0.2 / 16)
    # the launch counter disagrees with the calls the shapes imply: nothing
    assert mod('attn_roofline.batch').read(ctx) is None
    assert mod('mfu.batch').read(ctx) > 0
    ctx.device = {'platform': 'cpu', 'kind': 'cpu'}
    assert mod('idle_share.batch').read(ctx) is None
    assert mod('mfu.batch').read(ctx) is None
