"""The router fit (``router_fit.py``, a configuration's ``router_init``)
and ``weights_seed`` at a tiny routed configuration on the CPU: the fit
raises the kept share, one seed gives the same bits twice, the program and
the reference receive the same fitted router, and a configuration without
the keys gets the weights it got before they existed."""

import hashlib

import harness
import pytest
import router_fit
import torch
import weights as seeded
from conftest import add_tiny_cell, tiny_config
from reference import model as ref

ROUTER = 'transformer.layers.{}.ffnet.router.weight'


def _config():
    """A routed configuration small enough for the CPU with as many
    positions as the fit needs to spread 8 experts (16 x 16 tokens)."""
    c = tiny_config('tiny-fit', moe=True)
    c['pipeline'].update(num_experts=8, dim=128, num_head=2, dim_head=64,
                         mlp_dim=256)
    c['t5_dim'] = 128
    for k in ('enc', 'dec'):
        c['stage1'][k]['image_size'] = 128
    c['stage1']['n_embed'] = 256
    return c


def _plain(c):
    return {k: v for k, v in c.items() if k != 'router_init'}


def test_fit_raises_the_kept_share():
    c = _config()
    cfg, seed = c['pipeline'], c['weights_seed']
    w = seeded.make(c, 21, 'cpu', torch.float32)
    report = w.router_fit
    assert len(report) == cfg['depth']
    assert max(r['kept_before'] for r in report) < 0.95
    assert all(r['kept_after'] >= 0.95 for r in report), report
    # layer 0's share, read again through the reference's own routing on
    # the grids the fit drew
    drawn = seeded.make(_plain(c), 21, 'cpu', torch.float32).tensors()
    p = c['router_init']
    g = torch.Generator().manual_seed(router_fit._fit_seed(seed))
    ctx = router_fit._contexts(c, p, g, 'cpu', torch.float32)
    grids = router_fit.sample_grids(drawn, c, p, ctx, g)
    W = w.tensors()
    steps, rows, n = grids.shape
    x, ctx = ref.embed(W, ref.sampling_table(W)[grids.reshape(-1, n)],
                       ctx.repeat(steps, 1, 1))
    kept = []
    for context in (ctx, None):
        h = ref.layer_norm(ref.attend(W, cfg, 0, x, context),
                           W['transformer.layers.0.norm3.weight'],
                           W['transformer.layers.0.norm3.bias'])
        for call in h.reshape(steps, rows, n, -1):
            kept.append(1.0 - float(ref.routed_ffn(
                W, 'transformer.layers.0.ffnet.', call, cfg)[1]))
    assert sum(kept) / len(kept) == pytest.approx(report[0]['kept_after'],
                                                  abs=1e-6)


def test_grids_follow_the_schedule():
    c = _config()
    p = c['router_init']
    W = seeded.make(_plain(c), 4, 'cpu', torch.float32).tensors()
    g = torch.Generator().manual_seed(5)
    grids = router_fit.sample_grids(
        W, c, p, router_fit._contexts(c, p, g, 'cpu', torch.float32), g)
    steps, rows, n = grids.shape
    mask_id = ref.sampling_table(W).shape[0] - 1
    left = (grids == mask_id).sum(-1)
    want = [n] + ref.mask_counts(n, steps)[:-1]
    assert left.tolist() == [[m] * rows for m in want]
    held = grids[:-1] != mask_id
    assert torch.equal(grids[1:][held], grids[:-1][held])


def test_position_targets_spread_the_experts():
    t = router_fit.position_targets(1024, 8, torch.Generator().manual_seed(1),
                                    'cpu')
    order = t.argsort(-1, descending=True)
    first, second = order[:, 0], order[:, 1]
    assert bool((first != second).all())
    for picks in (first, second):
        counts = torch.bincount(picks, minlength=8)
        assert int(counts.max() - counts.min()) <= 8, counts
    assert bool((t.gather(1, order[:, 2:3]) < t.gather(1, order[:, 1:2])).all())


@pytest.mark.parametrize('cf', [1.25, 0.5])
def test_routed_ffn_matches_the_reference(cf):
    c = _plain(_config())
    c['pipeline']['capacity_factor'] = cf
    W = seeded.make(c, 3, 'cpu', torch.float32).tensors()
    x = torch.randn(3, 16, 128, generator=torch.Generator().manual_seed(1))
    q = 'transformer.layers.1.ffnet.'
    want, dropped = ref.routed_ffn(W, q, x, c['pipeline'])
    got, _ = router_fit.routed_ffn(W, q, x, c['pipeline'])
    assert cf > 1 or float(dropped) > 0.0     # the dropping path runs
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_one_seed_gives_the_same_bits_twice():
    c = _config()
    del c['weights_seed']
    a = seeded.make(c, 2 ** 40 + 9, 'cpu', torch.bfloat16)
    b = seeded.make(c, 2 ** 40 + 9, 'cpu', torch.bfloat16)
    assert torch.equal(a.flat.view(torch.int16), b.flat.view(torch.int16))
    other = seeded.make(c, 2 ** 40 + 10, 'cpu', torch.bfloat16)
    assert not torch.equal(a.tensors()[ROUTER.format(0)],
                           other.tensors()[ROUTER.format(0)])


def test_weights_seed_fixes_the_draw():
    c = _config()
    a = seeded.make(c, 1, 'cpu', torch.bfloat16)
    b = seeded.make(c, 2 ** 33 + 1, 'cpu', torch.bfloat16)
    assert torch.equal(a.flat.view(torch.int16), b.flat.view(torch.int16))


def test_program_and_reference_receive_the_fitted_router(tmp_path):
    cell = add_tiny_cell(str(tmp_path), 'fit_cell', moe=True,
                         limits_from='moe_lb_t2i_b64')
    run = harness.Run(cell=cell, seed=33, device='cpu')
    s = cell.generator().setup(run)
    try:
        drawn = seeded.make(_plain(cell.config), run.rng_seed('weights'),
                            'cpu', torch.float32).tensors()
        got = s.weights.tensors()
        routers = {ROUTER.format(i)
                   for i in range(cell.config['pipeline']['depth'])}
        prog = dict(s.pipe.named_parameters())
        for name in routers:
            assert torch.equal(prog[name].detach().float(), got[name])
            assert not torch.equal(got[name], drawn[name])
        assert all(torch.equal(got[n], drawn[n]) for n in got
                   if n not in routers)
    finally:
        cell.generator().release(s)


# sha256 of the flat buffer ``weights.make`` gave for these tiny
# configurations before configurations had a ``router_init`` or a
# ``weights_seed``
BEFORE = [
    (False, torch.float32, 7,
     'ab8dd41b3a5ff6dc744feb49c35e9c4dfa0fc0d905b264b85f5fc7b52ba914f7'),
    (True, torch.bfloat16, 2 ** 40 + 3,
     '4d6106f0dc4ed9c44b6eb1785c67c7be471b2086674767ca21691198ab793d83'),
    (True, torch.float32, 11,
     'be0e1bdef7cb08e01d642f6601d452b408b891c41952075db0297b3b57d08de8'),
]


@pytest.mark.parametrize('moe,dtype,seed,digest', BEFORE,
                         ids=['dense-fp32', 'moe-bf16', 'moe-fp32'])
def test_weights_without_the_keys_are_unchanged(moe, dtype, seed, digest):
    c = _plain(tiny_config('t', moe))
    c.pop('weights_seed', None)
    w = seeded.make(c, seed, 'cpu', dtype)
    assert w.router_fit is None
    got = hashlib.sha256(w.flat.view(torch.uint8).numpy().tobytes())
    assert got.hexdigest() == digest
