"""The plain reference against the port's plain CPU path (fp32, plain
attention) at a tiny size, on the benchmark's seeded weights."""

import program
import pytest
import torch
import weights as seeded
from conftest import tiny_config
from reference import model as ref


def build(moe, experts=4, capacity_factor=1.25):
    c = tiny_config('tiny-ref-moe' if moe else 'tiny-ref', moe)
    c['compute_dtype'] = 'float32'
    if moe:
        c['pipeline'].update(num_experts=experts,
                             capacity_factor=capacity_factor)
        c['name'] += f'-{experts}-{capacity_factor}'
    w = seeded.make(c, 7, 'cpu', torch.float32)
    pipe = program.build_pipeline(c, w.tensors(), 'cpu')
    return c, w.tensors(), pipe


@pytest.mark.parametrize('moe,cf', [(False, 1.25), (True, 1.25), (True, 0.5)])
def test_transformer_logits(moe, cf):
    c, W, pipe = build(moe, capacity_factor=cf)
    g = torch.Generator().manual_seed(3)
    table = ref.sampling_table(W)
    ids = torch.randint(0, table.shape[0], (3, 16), generator=g)
    tokens = table[ids]
    ctx = torch.randn(3, 5, 1024, generator=g) * 0.25
    for context in (ctx, None):
        with torch.no_grad():
            out = pipe.transformer(tokens, context, backend='plain')
        got = out[0] if moe else out
        want = ref.transformer(W, c['pipeline'], tokens, context)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dropping_is_exercised():
    c, W, _ = build(True, capacity_factor=0.5)
    x = torch.randn(3, 16, 32, generator=torch.Generator().manual_seed(1))
    _, dropped = ref.routed_ffn(W, 'transformer.layers.0.ffnet.', x,
                                c['pipeline'])
    assert float(dropped) > 0.1


def test_guided_logits_mix():
    c, W, pipe = build(False)
    table = ref.sampling_table(W)
    ids = torch.randint(0, table.shape[0], (2, 16),
                        generator=torch.Generator().manual_seed(5))
    ctx = torch.randn(2, 5, 1024, generator=torch.Generator().manual_seed(6))
    cond = ref.transformer(W, c['pipeline'], table[ids], ctx)
    unc = ref.transformer(W, c['pipeline'], table[ids], None)
    mixed = ref.guided_logits(W, c['pipeline'], table[ids], ctx, 3.0)
    torch.testing.assert_close(mixed, unc + 3.0 * (cond - unc))


def test_decode():
    c, W, pipe = build(False)
    ids = torch.randint(0, 64, (3, 16), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = pipe.vqgan.decode_from_indice(ids, backend='plain')
    want = ref.decode(W, c['stage1'], ids)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ids_of_rows_and_schedule():
    c, W, _ = build(False)
    table = ref.sampling_table(W)
    ids = torch.arange(table.shape[0])
    got, dist = ref.ids_of_rows(table[ids], table)
    assert torch.equal(got, ids) and float(dist.max()) < 1e-5
    counts = ref.mask_counts(1024, 16)
    assert counts[0] == 1019  # int(cos(pi / 32) * 1024) and counts[-1] == 1
    assert all(a >= b for a, b in zip(counts, counts[1:]))


def test_int8_control_differs():
    c, W, _ = build(False)
    table = ref.sampling_table(W)
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(9))
    full = ref.transformer(W, c['pipeline'], table[ids], None)
    low = ref.transformer(W, c['pipeline'], table[ids], None, lowp='int8')
    err = float((full - low).abs().max())
    assert 1e-4 < err < 1.0
