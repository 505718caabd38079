"""The operation and byte counts against reckonings by hand."""

import json
import os

import flops
import peaks
import pytest
from conftest import BENCH


def conf(name):
    with open(os.path.join(BENCH, 'configs', name + '.json')) as f:
        return json.load(f)


def test_dense_pass_per_token():
    # d = 1024, h = 2736, N = 1024, M = 77, 12 layers
    d, h, n, m = 1024, 2736, 1024, 77
    self_attn = 8 * d * d + 4 * n * d                  # 8.39 + 4.19 M
    cross = 4 * d * d + 4 * m * d * d / n + 4 * m * d  # 4.19 + 0.32 + 0.32 M
    layer = self_attn + cross + 6 * d * h              # + 16.81 M
    want = 2 * 32 * d + 12 * layer
    assert flops.pass_flops_per_token(conf('paintmindv1'), 77, True) == \
        pytest.approx(want)
    assert want / 1e6 == pytest.approx(410.68, abs=0.01)
    unc = flops.pass_flops_per_token(conf('paintmindv1'), 77, False)
    assert unc / 1e6 == pytest.approx(503.78, abs=0.01)
    assert flops.head_flops_per_token(conf('paintmindv1')) == 2 * 1024 * 8192


def test_moe_pass_per_token():
    d, h = 1024, 2736
    dense = flops.pass_flops_per_token(conf('paintmindv1'), 77, True)
    moe = flops.pass_flops_per_token(conf('paintmindv1-moe'), 77, True)
    # a second active expert and the router, per layer
    assert moe - dense == pytest.approx(12 * (6 * d * h + 2 * d * 8))
    half = flops.pass_flops_per_token(conf('paintmindv1-moe'), 77, True, 0.5)
    assert moe - half == pytest.approx(12 * 6 * d * h)


def test_generate_call():
    c = conf('paintmindv1')
    per_tok = (flops.pass_flops_per_token(c, 77, True)
               + flops.pass_flops_per_token(c, 77, False)
               + 2 * 1024 * 8192)
    # decoder: 8 layers at width 512, 1024 patches, + projections
    dec = 1024 * (8 * (8 * 512 * 512 + 4 * 1024 * 512 + 6 * 512 * 1368)
                  + 2 * 512 * 192 + 2 * 32 * 512)
    assert flops.decode_flops_per_image(c) == dec
    total = flops.generate_flops(c, 32, 16, 77, True)
    assert total == pytest.approx(32 * (1024 * 16 * per_tok + dec))
    assert total / 1e12 == pytest.approx(490.44, abs=0.01)


def test_attention_bounds():
    h100 = peaks.H100
    # K1, B = 32, H = 16, N = M = 1024, D = 64, bf16: operations bound it
    ops, nbytes = flops.attention_cost(32, 16, 1024, 1024, 64)
    assert ops == 4 * 32 * 16 * 1024 * 1024 * 64
    assert nbytes == 4 * 32 * 1024 * 16 * 64 * 2
    assert flops.bound_seconds(ops, nbytes, h100) == pytest.approx(ops / 989e12)
    # cross-attention over 77 keys: bytes bound it
    ops, nbytes = flops.attention_cost(32, 16, 1024, 77, 64)
    assert flops.bound_seconds(ops, nbytes, h100) == pytest.approx(
        nbytes / 3.35e12)
    # K4 is 2.5 times K1's operations
    ops_b, _ = flops.attention_cost(32, 16, 1024, 1024, 64, backward=True)
    assert ops_b == 2.5 * 4 * 32 * 16 * 1024 * 1024 * 64


def test_attention_calls_of_a_guided_call():
    calls = flops.generate_attention_calls(conf('paintmindv1'), 32, 16, 77,
                                           True)
    # 16 steps x 12 layers x (3 self + 1 cross) + 8 decoder layers = 776
    assert sum(n for n, *_ in calls) == 776
