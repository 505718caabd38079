"""The port's GPipe pipeline parallelism (``parallel/pipeline_parallel.py``)
held against the JAX package on the CPU: the pipelined stacks (dense and
MoE) and their gradients, the shape checks and guards, the pipelined
trainer and decode against their unpipelined runs.

Two layouts run once each as gloo processes (``_torch_dist.run``, each with
its own time limit): four stages (data 1, model 4) and two stages of two
data ranks (data 2, model 2).  The JAX references run here at the sizes of
``tests/test_pipeline_parallel.py`` (DIM 32, 2 heads of 16, MLP 64).
Tolerances: 1e-5 max abs for stacks and gradients, 1e-4 for the stage-2
transformer (as the JAX tests), sampled ids equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import transformer as jst2
from paintmind_tpu.nn.moe import init_moe_stack, moe_stack_apply
from paintmind_tpu.nn.transformer import init_stack, stack_apply
from paintmind_tpu.utils.checkpoint import flatten_tree

from _torch_dist import run

DIM, HEADS, DIM_HEAD, MLP = 32, 2, 16, 64
SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
VQ_NAME = 'torch-pp-vqgan'
jcfg.register_version(VQ_NAME, SMALL_VQ)
PIPE_KW = dict(stage1=VQ_NAME, t5='t5-l', dim=DIM, dim_head=DIM_HEAD,
               mlp_dim=MLP, num_head=HEADS, depth=4, dropout=0.0, t5_dim=48)
MOE_KW = dict(PIPE_KW, num_experts=4, capacity_factor=2.0, lb_weight=0.0)
TCFG = dict(in_dim=8, dim=DIM, len_seq=16, dim_head=DIM_HEAD, mlp_dim=MLP,
            num_head=HEADS, depth=4, dropout=0.0, context_dim=24,
            num_classes=64)


def _flat(tree, prefix=None):
    tree = tree if prefix is None else {prefix: tree}
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _stack(depth, cross, seed=0):
    return init_stack(jax.random.PRNGKey(seed), depth, DIM,
                      dim_head=DIM_HEAD, mlp_dim=MLP, num_head=HEADS,
                      cross=cross, context_dim=DIM if cross else None)


def _moe(depth, seed=0):
    return init_moe_stack(jax.random.PRNGKey(seed), depth, DIM,
                          dim_head=DIM_HEAD, mlp_dim=MLP, num_head=HEADS,
                          num_experts=4, cross=True, context_dim=DIM)


def _by_layer(tree):
    """A depth-stacked JAX gradient tree -> {'<layer>.<torch name>': array}."""
    from paintmind_tpu_torch.convert.from_jax import to_state_dict
    sd = to_state_dict(flatten_tree({'layers': tree}))
    return {k[len('layers.'):]: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope='module')
def setup():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p8, p4 = _stack(8, True), _stack(4, True, seed=1)
    p4s, p6s = _stack(4, False, seed=2), _stack(6, False, seed=3)
    m8, m4 = _moe(8), _moe(4, seed=1)
    x8, ctx8 = f32(8, 16, DIM), f32(8, 5, DIM)
    xb, cb, tgt = f32(4, 16, DIM), f32(4, 5, DIM), f32(4, 16, DIM)
    xm, cm = f32(4, 16, DIM), f32(4, 5, DIM)
    x16, ctx16 = f32(16, 16, DIM), f32(16, 5, DIM)
    tcfg = jst2.CondTransformerConfig(**TCFG)
    tparams = jst2.init_cond_transformer(jax.random.PRNGKey(1), tcfg)
    tx, tctx = f32(4, 16, 8), f32(4, 5, 24)
    j = {}
    kw = dict(heads=HEADS, backend='xla')
    for m in (2, 4):
        j[f'stack_m{m}'] = stack_apply(p8, jnp.asarray(x8), jnp.asarray(ctx8),
                                       **kw)
    j['no_ctx'] = stack_apply(p4s, jnp.asarray(x8), **kw)
    j['stack16'] = stack_apply(p4, jnp.asarray(x16), jnp.asarray(ctx16), **kw)

    def loss(p_):
        out = stack_apply(p_, jnp.asarray(xb), jnp.asarray(cb), **kw)
        return jnp.mean((out - jnp.asarray(tgt)) ** 2)

    j['grads'] = _by_layer(jax.grad(loss)(p4))
    j['moe'], j['moe_aux'] = moe_stack_apply(
        m8, jnp.asarray(xm), jnp.asarray(cm), capacity_factor=2.0,
        dispatch='gather', **kw)

    def moe_loss(p_):
        out, aux = moe_stack_apply(p_, jnp.asarray(xb), jnp.asarray(cb),
                                   capacity_factor=2.0, dispatch='gather',
                                   **kw)
        return jnp.mean((out - jnp.asarray(tgt)) ** 2) + 1e-3 * aux['router_z']

    j['moe_grads'] = _by_layer(jax.grad(moe_loss)(m4))
    j['transformer'] = jst2.cond_transformer_apply(
        tparams, jnp.asarray(tx), jnp.asarray(tctx), cfg=tcfg, backend='xla')
    j = jax.tree_util.tree_map(np.asarray, j)
    inputs = {
        'register': {VQ_NAME: SMALL_VQ}, 'vq': SMALL_VQ, 'pipe_kw': PIPE_KW,
        'moe_kw': MOE_KW, 'stack8': _flat(p8, 'layers'),
        'stack4': _flat(p4, 'layers'), 'stack4_self': _flat(p4s, 'layers'),
        'stack6_self': _flat(p6s, 'layers'), 'moe8': _flat(m8, 'layers'),
        'moe4': _flat(m4, 'layers'), 'x8': x8, 'ctx8': ctx8, 'xb': xb,
        'cb': cb, 'tgt': tgt, 'xm': xm, 'cm': cm, 'x16': x16,
        'ctx16': ctx16, 'tcfg': TCFG, 'tflat': _flat(tparams), 'tx': tx,
        'tctx': tctx, 'gctx': f32(4, 5, 48),
    }
    return inputs, j


@pytest.fixture(scope='module')
def runs(setup, tmp_path_factory):
    inputs = {**setup[0], 'dir': str(tmp_path_factory.mktemp('pp'))}
    return {'s4': run('pp', 4, inputs, model_parallel=4),
            's2': run('pp2', 4, inputs, model_parallel=2)}


@pytest.mark.parametrize('microbatches', [2, 4])
def test_pp_stack_four_stages_matches_jax(runs, setup, microbatches):
    """``test_pipeline_parallel.py:35``: (S 4, M 2) and (4, 4), depth 8 with
    context, every stage's replicated output within 1e-5 of JAX's
    ``stack_apply``."""
    for o in runs['s4']:
        assert _maxabs(o[f'stack_m{microbatches}'],
                       setup[1][f'stack_m{microbatches}']) < 1e-5
        assert o['counts']['send_recv'] > 0


def test_pp_stack_two_stages_with_data_parallel(runs, setup):
    """(S 2, M 4) on two data ranks: each data rank's rows through its
    pipeline, within 1e-5 of JAX on the global batch."""
    outs = runs['s2']
    got = np.concatenate([outs[0]['stack_m4'], outs[2]['stack_m4']])
    assert _maxabs(got, setup[1]['stack16']) < 1e-5
    np.testing.assert_array_equal(outs[0]['stack_m4'], outs[1]['stack_m4'])


def test_pp_stack_no_context(runs, setup):
    for o in runs['s4']:
        assert _maxabs(o['no_ctx'], setup[1]['no_ctx']) < 1e-5


def test_pp_backward_matches_jax(runs, setup):
    """``test_pipeline_parallel.py:103``: the schedule's backward (each
    stage's gradients, the hops reversed) within 1e-5 of ``jax.grad`` of
    the unpipelined stack."""
    want = setup[1]['grads']
    got = {}
    for o in runs['s4']:
        assert not set(got) & set(o['grads'])
        got.update(o['grads'])
    assert got.keys() == want.keys()
    assert max(_maxabs(got[k], want[k]) for k in want) < 1e-5


def test_pp_validates_shapes(runs):
    """``test_pipeline_parallel.py:129``: 6 layers over 4 stages and a batch
    of 3 in 2 microbatches are refused, as in JAX."""
    o = runs['s4'][0]
    assert 'depth 6 must be divisible by 4' in o['depth_error']
    assert 'batch 3 must be divisible by dp=1 × microbatches=2' in \
        o['batch_error']


def test_pp_moe_stack_and_aux_match_jax(runs, setup):
    """``test_pipeline_parallel.py:300``: the pipelined MoE stack at a
    no-drop capacity (cf = E/k): outputs within 1e-5 of JAX's unpipelined
    stack, nothing dropped, router z-loss within 1e-5 and expert loads
    within 1e-6 (grouping-invariant), the load-balance loss finite."""
    want, aux = setup[1]['moe'], setup[1]['moe_aux']
    for o in runs['s4']:
        assert _maxabs(o['moe'], want) < 1e-5
        assert float(o['moe_aux']['dropped']) == 0.0 == float(aux['dropped'])
        assert abs(float(o['moe_aux']['router_z'])
                   - float(aux['router_z'])) < 1e-5
        assert _maxabs(o['moe_aux']['expert_load'], aux['expert_load']) < 1e-6
        assert np.isfinite(o['moe_aux']['lb_loss'])


def test_pp_moe_backward_matches_jax(runs, setup):
    """``test_pipeline_parallel.py:335``: gradients through the pipelined
    routed stack (routing, capacity scatter, the hops) within 1e-5 of JAX's
    and of the port's unpipelined stack."""
    want = setup[1]['moe_grads']
    got = {}
    for o in runs['s4']:
        got.update(o['moe_grads'])
    ref = runs['s4'][0]['moe_grads_ref']
    assert got.keys() == want.keys() == ref.keys()
    assert max(_maxabs(got[k], want[k]) for k in want) < 1e-5
    assert max(_maxabs(got[k], ref[k]) for k in ref) < 1e-5


def test_pp_cond_transformer_matches_jax(runs, setup):
    """``test_pipeline_parallel.py:85``: ``shard_for_pp`` keeps a stage's
    layers only; the pipelined transformer within 1e-4 of JAX's apply."""
    for s, o in enumerate(runs['s4']):
        assert o['held'] == [s]
        # pp_cond_transformer_param_spec names what each stage holds, the
        # embedding and the head replicated
        assert o['spec_held']
        assert o['spec_replicated'] and not any(
            n.startswith('layers.') for n in o['spec_replicated'])
        assert _maxabs(o['transformer'], setup[1]['transformer']) < 1e-4


def test_pp_guards(runs):
    """``test_pipeline_parallel.py:248``: the dense pipelined apply refuses
    an MoE transformer (TypeError), a depth the stages do not divide and a
    mesh of one stage are refused (ValueError)."""
    o = runs['s4'][0]
    assert 'MoE' in o['moe_type_error']
    assert 'depth 3 must be divisible by 4' in o['pipe_depth_error']
    assert 'needs >= 2 stages' in o['stages_error']


@pytest.mark.parametrize('name', ['dense', 'moe'])
def test_pp_trainer_matches_plain_trainer(runs, name):
    """``test_pipeline_parallel.py:157`` (dense) and ``:361`` (MoE, no-drop
    capacity, lb weight 0): ``PaintMindTrainer(pp_microbatches=2)`` on
    (data 2, stages 2) takes the plain one-process trainer's steps, its loss
    within 1e-4 and its gathered weights within 1e-5 (AdamW: no Lion sign
    flip amplifies the microbatches' rounding)."""
    for o in runs['s2']:
        (st, sl, sw), (pt_, pl_, pw) = (o[f'trainer_{name}'][True],
                                        o[f'trainer_{name}'][False])
        assert st == pt_ > 0
        assert abs(sl - pl_) < 1e-4
        assert sw.keys() == pw.keys()
        assert max(_maxabs(sw[k], pw[k]) for k in pw) < 1e-5


@pytest.mark.parametrize('name', ['dense', 'moe'])
def test_pp_disable_returns_to_the_unstaged_decode(runs, name):
    """``test_pipeline_parallel.py:240``: after ``disable_pipeline_parallel``
    the decode is the unstaged one (ids equal, images within 1e-5: JAX's own
    check) on a whole ``nn.ModuleList`` stack; enabled again, it gives the
    first staged decode's ids and images bit for bit."""
    for o in runs['s2']:
        res = o[f'generate_{name}']
        assert res['unstaged']
        for (di, dids), (bi, bids) in zip(res[False], res['disabled']):
            np.testing.assert_array_equal(bids, dids)
            assert _maxabs(bi, di) < 1e-5
        for (si, sids), (ai, aids) in zip(res[True], res['again']):
            np.testing.assert_array_equal(aids, sids)
            np.testing.assert_array_equal(ai, si)


def test_pp_quantize_on_a_staged_pipeline(runs):
    """``quantize('w8')`` after ``enable_pipeline_parallel``: the stages'
    int8 layers gathered equal the unstaged ``quantize('w8')`` bit for bit
    (the JAX package quantizes the stage-placed global tree), the staged
    int8 decode gives the unstaged int8 decode's ids with images within 1e-4
    (the staged test's bound), and after ``disable_pipeline_parallel`` the
    pipeline holds the unstaged int8 tensors in their order and decodes
    them bit for bit.  Staging a sharded pipeline raises."""
    for o in runs['s2']:
        assert o['pp_quant_full_equal'] and o['pp_quant_unstaged_equal']
        res = o['pp_quant_decode']
        for (wi, wids), (si, sids), (ui, uids) in zip(
                res['whole'], res['staged'], res['unstaged']):
            np.testing.assert_array_equal(sids, wids)
            assert _maxabs(si, wi) < 1e-4
            np.testing.assert_array_equal(uids, wids)
            np.testing.assert_array_equal(ui, wi)
        assert 'already placed' in o['sharded_stage_error']


@pytest.mark.parametrize('name', ['dense', 'moe'])
def test_pp_generate_matches_dense(runs, name):
    """``test_pipeline_parallel.py:216`` and ``:403``: the pipelined decode
    (temperature 0, top-1) gives the dense decode's ids, unguided and
    guided (hidden-mix for dense, logit-mix for MoE), images within 1e-4."""
    for o in runs['s2']:
        dense, staged = o[f'generate_{name}'][False], o[f'generate_{name}'][True]
        for (di, dids), (si, sids) in zip(dense, staged):
            np.testing.assert_array_equal(sids, dids)
            assert _maxabs(si, di) < 1e-4
