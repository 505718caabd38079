"""The port's MoE stage-2 family (``nn/moe.py``,
``models/moe_transformer.py`` and the MoE branches of the pipeline, the
train step, the trainer and the command lines) held against the JAX
package on the CPU; the engine's MoE test is in ``test_torch_serving.py``.

Sizes: the JAX MoE tests' ``DIM = 16``, ``MLP = 32`` for the routed layer;
a registered tiny MoE pipeline (depth 2, E = 4, top-2, capacity factor 2,
t5_dim 48 so ``context_proj`` runs) for the rest.  Parameters are JAX inits
carried over by the weight bridge; masking and Gumbel noise are the numbers
JAX draws, handed to the port.  Tolerances (fp32 unless a test says
otherwise): routed outputs 1e-5 max abs, routing decisions equal, aux
values 1e-6 with ``dropped`` exact, gradients 1e-4 mean relative, logits
1e-5 max abs, sampled ids equal."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import moe_transformer as jmt
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.nn import moe as jmoe
from paintmind_tpu.nn.core import linear as jlinear
from paintmind_tpu.nn.mlp import swiglu as jswiglu
from paintmind_tpu.train import steps as jsteps
from paintmind_tpu.utils.checkpoint import flatten_tree
import paintmind_tpu_torch as pt
from paintmind_tpu_torch.convert.from_jax import load_jax_params, \
    to_flat, to_state_dict
from paintmind_tpu_torch.models import moe_transformer as tmt
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.nn import moe as tmoe
from paintmind_tpu_torch.nn.mlp import SwiGLU
from paintmind_tpu_torch.train import steps as tsteps

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

DIM, MLP = 16, 32
# the JAX side compiled once per shape: op-by-op dispatch costs more here
j_moe_swiglu = jax.jit(jmoe.moe_swiglu, static_argnames=(
    'num_selected', 'capacity_factor', 'dispatch'))

TINY_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
TINY_MOE = {'stage1': 'torch-moe-vqgan', 't5': 't5-l', 'dim': 32,
            'dim_head': 16, 'mlp_dim': 64, 'num_head': 2, 'depth': 2,
            'dropout': 0.0, 'num_experts': 4, 'num_selected': 2,
            'capacity_factor': 2.0}
for _reg in (jcfg, pt):
    _reg.register_version('torch-moe-vqgan', TINY_VQ)
    _reg.register_version('torch-moe-pipeline', TINY_MOE)

PIPE_KW = dict(stage1='torch-moe-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, depth=2, t5_dim=48, num_experts=4,
               num_selected=2, capacity_factor=2.0)
J_PIPE = jpl.PipelineConfig(vqc=jvm.VQModelConfig.from_dict(TINY_VQ),
                            dropout=0.0, **PIPE_KW)
L = J_PIPE.num_tokens
V = J_PIPE.vqc.n_embed
MASK = J_PIPE.mask_token_id


def t_cfg(dropout=0.0):
    return tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(TINY_VQ),
                              dropout=dropout, **PIPE_KW)


def _np(t):
    return t.detach().cpu().numpy()


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _images(seed, b):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, 32, 32, 3)).astype(np.float32)


def _context(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 5, 48)).astype(np.float32)


# ---------------------------------------------------------------------------
# the routed layer
# ---------------------------------------------------------------------------

def _layer(seed, e, **kw):
    """A JAX ``init_moe_swiglu`` tree and the port's layer holding it."""
    p = jmoe.init_moe_swiglu(jax.random.PRNGKey(seed), DIM, MLP,
                             num_experts=e)
    layer = tmoe.MoESwiGLU(DIM, MLP, e, device='cpu', **kw)
    return p, load_jax_params(layer, flatten_tree(p))


def _jax_route(p, x, k, cf):
    """The routing decisions of JAX ``moe_swiglu`` (``nn/moe.py:98-111``),
    in JAX: ``(idx, keep)``."""
    e = jmoe.num_experts(p)
    xt = x.reshape(-1, x.shape[-1])
    t = xt.shape[0]
    probs = jax.nn.softmax(jlinear(p['router'], xt.astype(jnp.float32)), -1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    cap = max(1, int(t * k / e * cf + 0.999))
    flat = jax.nn.one_hot(idx, e, dtype=jnp.float32).transpose(1, 0, 2) \
        .reshape(k * t, e)
    pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1) \
        .reshape(k, t).transpose().astype(jnp.int32)
    return np.asarray(idx), np.asarray((pos < cap) & (gate > 0))


# (E, k, capacity factor): ample room, drops, 8 experts, capacity 1
LAYER_CASES = [(4, 2, 1.25), (4, 2, 0.5), (8, 2, 2.0), (2, 1, 0.02)]


@pytest.mark.parametrize('dispatch', ['gather', 'dense'])
@pytest.mark.parametrize('e,k,cf', LAYER_CASES)
def test_moe_swiglu_matches_jax(dispatch, e, k, cf):
    """``moe_swiglu`` against JAX's on the same tree and 60 tokens: y within
    1e-5 max abs, the routing (experts and kept assignments) equal, lb loss,
    router z and the expert load within 1e-6, ``dropped`` exact."""
    p, layer = _layer(e, e)
    x = np.random.default_rng(e * 10 + k).standard_normal(
        (3, 20, DIM)).astype(np.float32)
    jy, jaux = j_moe_swiglu(p, jnp.asarray(x), num_selected=k,
                            capacity_factor=cf, dispatch=dispatch)
    with torch.no_grad():
        y, aux = tmoe.moe_swiglu(layer, torch.from_numpy(x), k, cf, dispatch)
        _, _, _, idx, _, keep, cap = tmoe.route(
            layer, torch.from_numpy(x).reshape(-1, DIM), k, cf)
    jidx, jkeep = _jax_route(p, jnp.asarray(x), k, cf)
    np.testing.assert_array_equal(_np(idx), jidx)
    np.testing.assert_array_equal(_np(keep), jkeep)
    assert cap == max(1, int(60 * k / e * cf + 0.999))
    if cf == 0.02:
        assert cap == 1
    assert y.shape == (3, 20, DIM) and _maxabs(_np(y), jy) <= 1e-5
    for name in ('lb_loss', 'router_z', 'expert_load'):
        assert _maxabs(_np(aux[name]), jaux[name]) <= 1e-6, name
    # ``dropped`` exact against JAX's expression on JAX's keep, eager (under
    # jit XLA rounds 1 - mean(keep) its own way: -5e-8 for 0)
    jdropped = 1.0 - jnp.asarray(jkeep).astype(jnp.float32).mean()
    assert float(aux['dropped']) == float(jdropped)
    assert abs(float(jaux['dropped']) - float(jdropped)) <= 1e-6
    if cf < 1:
        assert float(aux['dropped']) > 0


def test_single_expert_equals_dense_swiglu():
    """E = 1, k = 1, room for every token: the layer is the dense SwiGLU of
    its one expert (the port's ``SwiGLU`` and JAX's ``swiglu``), lb loss 1."""
    p, layer = _layer(0, 1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 6, DIM)).astype(np.float32))
    dense = SwiGLU(DIM, MLP, device='cpu')
    for name in ('w12', 'w3'):
        getattr(dense, name).weight.data = \
            getattr(layer.experts, name).weight[0].clone()
        getattr(dense, name).bias.data = \
            getattr(layer.experts, name).bias[0].clone()
    with torch.no_grad():
        y, aux = tmoe.moe_swiglu(layer, x, 1, 2.0)
        ref = dense(x)
    jref = jswiglu(jax.tree_util.tree_map(lambda v: v[0], p['experts']),
                   jnp.asarray(_np(x)))
    assert _maxabs(_np(y), _np(ref)) <= 1e-6
    assert _maxabs(_np(y), jref) <= 1e-6
    assert float(aux['dropped']) == 0.0
    assert abs(float(aux['lb_loss']) - 1.0) <= 1e-6


def _expert(layer, i, x):
    """Expert ``i`` of the port's layer on (T, D) tokens, by hand."""
    w12, w3 = layer.experts.w12, layer.experts.w3
    h = x @ w12.weight[i].t() + w12.bias[i]
    x1, x2 = h.chunk(2, -1)
    return (torch.nn.functional.silu(x1) * x2) @ w3.weight[i].t() + w3.bias[i]


def test_top1_routing_selects_argmax_expert():
    """k = 1 with ample capacity: each token's output is its argmax
    expert's (the renormalised gate is 1)."""
    p, layer = _layer(1, 4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, DIM)).astype(np.float32))
    with torch.no_grad():
        y, aux = tmoe.moe_swiglu(layer, x, 1, 8.0)
        choice = (x @ layer.router.weight.t()).argmax(-1)
        for t in range(8):
            ref = _expert(layer, int(choice[t]), x[t:t + 1])[0]
            assert _maxabs(_np(y[t]), _np(ref)) <= 1e-5, t
    assert float(aux['dropped']) == 0.0


def test_capacity_drops_overflow_tokens():
    """Every token prefers expert 0 and its capacity is 1: one assignment
    survives, the other seven are dropped (their rows are 0)."""
    p, layer = _layer(2, 2)
    with torch.no_grad():
        layer.router.weight.zero_()
        layer.router.weight[0] = 1.0
    x = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (8, DIM))).astype(np.float32))
    for dispatch in ('gather', 'dense'):
        with torch.no_grad():
            y, aux = tmoe.moe_swiglu(layer, x, 1, 0.25, dispatch)
        assert int((y.abs() > 0).any(-1).sum()) == 1, dispatch
        assert (y[0].abs() > 0).any()  # the first in the queue is served
        assert float(aux['dropped']) == pytest.approx(7 / 8)


def test_top2_gates_renormalised_and_mixed():
    """k = 2: y = g1'·E_a(x) + g2'·E_b(x) with g' the top-2 softmax gates
    renormalised to sum to 1."""
    p, layer = _layer(3, 4)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, DIM)).astype(np.float32))
    with torch.no_grad():
        y, _ = tmoe.moe_swiglu(layer, x, 2, 8.0)
        probs = torch.softmax(x @ layer.router.weight.t(), -1)
        for t in range(5):
            top = torch.argsort(probs[t], descending=True)[:2]
            g = probs[t][top] / probs[t][top].sum()
            ref = sum(g[i] * _expert(layer, int(top[i]), x[t:t + 1])[0]
                      for i in range(2))
            assert _maxabs(_np(y[t]), _np(ref)) <= 1e-5, t


@pytest.mark.parametrize('k', [1, 2])
def test_tied_router_columns_route_as_jax(k):
    """E = 4 with router columns 0 and 2 equal and dominant: the two
    probabilities are equal, and the tie goes to the lower index, as
    ``jax.lax.top_k`` breaks it (``torch.topk`` promises no order)."""
    p = jmoe.init_moe_swiglu(jax.random.PRNGKey(5), DIM, MLP, num_experts=4)
    kern = np.asarray(p['router']['kernel']).copy() * 0.01
    kern[:, 0] = kern[:, 2] = np.linspace(0.5, 1.5, DIM)
    p['router']['kernel'] = jnp.asarray(kern)
    layer = load_jax_params(tmoe.MoESwiGLU(DIM, MLP, 4, device='cpu'),
                            flatten_tree(p))
    x = np.abs(np.random.default_rng(5).standard_normal(
        (12, DIM))).astype(np.float32)
    _, _, gate, idx, _, _, _ = tmoe.route(layer, torch.from_numpy(x), k, 4.0)
    jidx, _ = _jax_route(p, jnp.asarray(x), k, 4.0)
    np.testing.assert_array_equal(_np(idx), jidx)
    assert (_np(idx)[:, 0] == 0).all()
    if k == 2:
        assert (_np(idx)[:, 1] == 2).all()
        assert torch.equal(gate[:, 0], gate[:, 1])
    jy, _ = j_moe_swiglu(p, jnp.asarray(x), num_selected=k,
                         capacity_factor=4.0)
    with torch.no_grad():
        y, _ = tmoe.moe_swiglu(layer, torch.from_numpy(x), k, 4.0)
    assert _maxabs(_np(y), jy) <= 1e-5


@pytest.mark.parametrize('dispatch', ['gather', 'dense'])
def test_moe_swiglu_gradients_match_jax(dispatch):
    """Gradients of ``sum(y·w) + lb_loss + router_z`` with respect to x, the
    router and the experts, at a capacity that drops (cf 0.5), against
    ``jax.grad``: <= 1e-4 mean relative per leaf.  The gate's gradient runs
    through the combine weights and the lb loss's mean probabilities."""
    e, k, cf = 4, 2, 0.5
    p, layer = _layer(7, e)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, DIM)).astype(np.float32)
    w = rng.standard_normal((2, 24, DIM)).astype(np.float32)

    def jloss(p_, x_):
        y, aux = jmoe.moe_swiglu(p_, x_, num_selected=k, capacity_factor=cf,
                                 dispatch=dispatch)
        return jnp.sum(y * w) + aux['lb_loss'] + aux['router_z']

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    layer.requires_grad_(True)
    y, aux = tmoe.moe_swiglu(layer, xt, k, cf, dispatch)
    ((y * torch.from_numpy(w)).sum() + aux['lb_loss']
     + aux['router_z']).backward()
    assert float(aux['dropped']) > 0
    assert _rel(_np(xt.grad), jgx) <= 1e-4
    want = to_state_dict(flatten_tree(jgp))
    named = dict(layer.named_parameters())
    assert set(want) == set(named)
    for name, ref in want.items():
        assert _rel(_np(named[name].grad), ref.numpy()) <= 1e-4, name
    assert float(named['router.weight'].grad.abs().max()) > 0


def test_gather_and_dense_agree_in_bf16():
    """bf16 activations: both dispatch forms route the same and give y
    within 1e-2 max abs of each other (JAX's ``test_gather_dispatch_bf16``
    tolerance) and of JAX's bf16 gather; the output stays bf16."""
    p, layer = _layer(4, 4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, DIM)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        yg, ag = tmoe.moe_swiglu(layer, x, 2, 1.25, 'gather')
        yd, ad = tmoe.moe_swiglu(layer, x, 2, 1.25, 'dense')
    jy, _ = j_moe_swiglu(p, jnp.asarray(_np(x.float()), jnp.bfloat16),
                         dispatch='gather')
    assert yg.dtype == yd.dtype == torch.bfloat16
    assert _maxabs(_np(yg.float()), _np(yd.float())) <= 1e-2
    assert _maxabs(_np(yg.float()), np.asarray(jy, np.float32)) <= 1e-2
    assert torch.equal(ag['expert_load'], ad['expert_load'])
    assert float(ag['dropped']) == float(ad['dropped'])


# ---------------------------------------------------------------------------
# the transformer and the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jparams():
    return jax.jit(lambda k: jpl.init_pipeline(k, J_PIPE))(
        jax.random.PRNGKey(0))


def make_pipe(jparams, dropout=0.0):
    pipe = tpl.Pipeline(t_cfg(dropout), stage1_pretrained=False,
                        text_encoder=None, device='cpu')
    return load_jax_params(pipe, flatten_tree(jparams))


@pytest.mark.parametrize('with_context', [True, False])
def test_moe_transformer_matches_jax(jparams, with_context):
    """``MoECondTransformer`` against ``moe_cond_transformer_apply``: logits
    within 1e-5 max abs, aux within 1e-6; ``moe_masked_loss`` within 1e-5;
    ``tokens2logits`` returns the logits."""
    pipe = make_pipe(jparams)
    assert isinstance(pipe.transformer, tmt.MoECondTransformer)
    rng = np.random.default_rng(11)
    tokens = rng.standard_normal((2, L, 8)).astype(np.float32)
    ctx = _context(12, 2) if with_context else None
    jl, jaux = jax.jit(lambda p, t, c: jmt.moe_cond_transformer_apply(
        p, t, c, cfg=J_PIPE.tcfg, backend='xla'))(
        jparams['transformer'], jnp.asarray(tokens),
        None if ctx is None else jnp.asarray(ctx))
    tctx = None if ctx is None else torch.from_numpy(ctx)
    with torch.no_grad():
        logits, aux = pipe.transformer(torch.from_numpy(tokens), tctx)
    assert _maxabs(_np(logits), jl) <= 1e-5
    for name in jaux:
        assert _maxabs(_np(aux[name]), jaux[name]) <= 1e-6, name
    assert _maxabs(_np(pipe.tokens2logits(tokens, ctx)), jl) <= 1e-5
    labels = rng.integers(0, V, (2, L)).astype(np.int32)
    mask = (rng.random((2, L)) > 0.5).astype(np.float32)
    jloss, jm = jmt.moe_masked_loss(
        jparams['transformer'], jnp.asarray(tokens), jnp.asarray(labels),
        jnp.asarray(mask), None if ctx is None else jnp.asarray(ctx),
        cfg=J_PIPE.tcfg)
    with torch.no_grad():
        loss, m = tmt.moe_masked_loss(pipe.transformer, torch.from_numpy(tokens),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(mask), tctx)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert abs(float(m['ce']) - float(jm['ce'])) <= 1e-5


def test_moe_remat_matches_plain_backward(jparams):
    """``remat=True`` with attention dropout on: the same loss, aux and
    gradients, bit for bit, and the generator left in the same state."""
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.standard_normal((2, L, 8)).astype(np.float32))
    ctx = torch.from_numpy(_context(14, 2))
    results = []
    for remat in (False, True):
        pipe = make_pipe(jparams, dropout=0.3)
        pipe.transformer.requires_grad_(True)
        pipe.train()
        g = torch.Generator().manual_seed(3)
        logits, aux = pipe.transformer(tokens, ctx, generator=g, remat=remat)
        (logits.square().mean() + aux['lb_loss'] + aux['router_z']).backward()
        results.append((logits.detach(), {n: v.detach() for n, v in aux.items()},
                        [p.grad.clone() for p in pipe.transformer.parameters()],
                        g.get_state()))
    (l0, a0, g0, s0), (l1, a1, g1, s1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a0[n], a1[n]) for n in a0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_moe_bridge_round_trip(tmp_path, jparams):
    """The JAX ``init_pipeline`` tree into the port and back through
    ``to_flat``: the same keys, shapes and bits (expert leaves (depth, E,
    in, out), the router (depth, D, E)); ``save_pretrained`` loads in the
    JAX package's ``Pipeline`` with the same logits (1e-5)."""
    pipe = make_pipe(jparams)
    want = flatten_tree(jparams)
    got = to_flat(pipe)
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key], np.asarray(v), err_msg=key)
    assert got['transformer/layers/ffnet/experts/w12/kernel'].shape == \
        (2, 4, 32, 2 * 48)
    assert got['transformer/layers/ffnet/router/kernel'].shape == (2, 32, 4)
    path = pipe.save_pretrained(str(tmp_path / 'moe.npz'))
    jpipe = jpl.Pipeline(J_PIPE, stage1_pretrained=False, text_encoder=None,
                         seed=5)
    jpipe.from_pretrained(path)
    tokens = np.random.default_rng(15).standard_normal((2, L, 8)).astype(
        np.float32)
    with torch.no_grad():
        mine = pipe.tokens2logits(tokens)
    assert _maxabs(_np(mine), jpipe.tokens2logits(tokens)) <= 1e-5
    again = make_pipe(jparams).from_pretrained(path)
    for (n, a), (_, b) in zip(pipe.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def _jax_noise(key, b):
    """The masking noise ``jpl.pipeline_loss`` draws from ``key``."""
    k_mask, _ = jax.random.split(key)
    return np.array(jax.random.uniform(k_mask, (b, L)))


def _grads_by_name(jtree):
    return to_state_dict(flatten_tree({'transformer': jtree['transformer'],
                                       'mask_token': jtree['mask_token']}))


@pytest.mark.parametrize('with_context', [True, False])
def test_moe_pipeline_loss_and_gradients_match_jax(jparams, with_context):
    """``pipeline_loss(return_aux=True)`` on JAX's masking noise (dropout
    0): the loss within 1e-5, the four routing metrics within 1e-6, every
    trainable gradient (router and experts included) within 1e-4 mean
    relative of ``jax.grad``."""
    b, key, ratio = 3, jax.random.PRNGKey(21), 0.6
    img, ctx = _images(2, b), _context(3, b) if with_context else None

    def jloss(p):
        return jpl.pipeline_loss(
            p, jnp.asarray(img), None if ctx is None else jnp.asarray(ctx),
            jnp.asarray(ratio, jnp.float32), key, cfg=J_PIPE,
            deterministic=False, backend='xla', return_aux=True)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    pipe = make_pipe(jparams)
    for p in pipe.trainable_parameters():
        p.requires_grad_(True)
    pipe.train()
    loss, m = tpl.pipeline_loss(
        pipe, torch.from_numpy(img),
        None if ctx is None else torch.from_numpy(ctx), ratio,
        noise=torch.from_numpy(_jax_noise(key, b)), return_aux=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert set(m) == set(jm) == {'lb loss', 'router z', 'dropped',
                                 'expert load'}
    for name in jm:
        assert _maxabs(_np(m[name]), jm[name]) <= 1e-6, name
    named = dict(pipe.named_parameters())
    checked = 0
    for name, ref in _grads_by_name(jg).items():
        if ctx is None and 'context_proj' in name:
            assert named[name].grad is None
            continue
        assert _rel(_np(named[name].grad), ref.numpy()) <= 1e-4, name
        checked += 1
    assert checked >= 30
    dense = tpl.PipelineConfig(vqc=t_cfg().vqc, **{**PIPE_KW,
                                                   'num_experts': 0})
    assert not isinstance(dense.tcfg, tmt.MoECondTransformerConfig)


def _noise(key, timesteps, b):
    keys = jax.random.split(key, timesteps)
    return [np.array(jpl._gumbel(k, (b, L, V))) for k in keys]


@pytest.mark.parametrize('mode', ['uncond', 'guided', 'negative'])
def test_moe_generate_ids_bit_equal(jparams, mode):
    """A 4-step decode with the exact sampler and JAX's per-step noise:
    final ids and trajectory equal, unguided, guided at 3.0 (two passes,
    logits mixed) and with a negative context in the unguided pass."""
    pipe = make_pipe(jparams)
    b, steps, key = 2, 4, jax.random.PRNGKey(len(mode) + 30)
    ctx = None if mode == 'uncond' else _context(31, b)
    neg = _context(32, b) if mode == 'negative' else None
    kw = dict(timesteps=steps, topk=3, temperature=1.0)
    if mode != 'uncond':
        kw['guidance_scale'] = 3.0
    init = np.full((b, L), MASK, np.int32)
    jf, jt = jpl.generate_ids(jparams, key, jnp.asarray(init),
                              None if ctx is None else jnp.asarray(ctx),
                              cfg=J_PIPE, backend='xla',
                              neg_context=None if neg is None
                              else jnp.asarray(neg), **kw)
    tf, tt = tpl.generate_ids(
        pipe, torch.from_numpy(init),
        None if ctx is None else torch.from_numpy(ctx), cfg=pipe.config,
        neg_context=None if neg is None else torch.from_numpy(neg),
        noise=torch.from_numpy(np.stack(_noise(key, steps, b))), **kw)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))


def _jax_step_noise(key, grad_accum, micro):
    key, k_step = jax.random.split(key)
    keys = jax.random.split(k_step, grad_accum)
    return np.concatenate([_jax_noise(k, micro) for k in keys])


def test_moe_lion_update_with_grad_accum_matches_jax(jparams):
    """One Lion update of two microbatches against JAX's
    ``make_pipeline_train_step`` on the same batch and masking noise: the
    loss within 1e-5, the four routing metrics (means over the
    microbatches) within 1e-6, and the weights with the tolerance of
    ``test_torch_train.py::test_one_lion_update_matches_jax`` (an entry
    whose sign flipped lands 2e-3 away: at most 0.1 % do; the rest agree to
    1e-7)."""
    b, lr = 4, 1e-3
    tx = jsteps.masked_tx(optax.lion(lr, b1=0.9, b2=0.99, weight_decay=0.05),
                          jparams)
    jstate = jsteps.init_pipeline_train_state(jax.random.PRNGKey(9), jparams,
                                              tx)
    jstep = jax.jit(jsteps.make_pipeline_train_step(J_PIPE, tx, grad_accum=2,
                                                    backend='xla'))
    pipe = make_pipe(jparams)
    opt = pt.optim.lion(pipe.trainable_parameters(), lr, (0.9, 0.99),
                        weight_decay=0.05)
    tstep = tsteps.make_pipeline_train_step(pipe, opt, grad_accum=2)
    img, ctx = _images(40, b), _context(41, b)
    noise = _jax_step_noise(jstate['key'], 2, b // 2)
    jstate, jm = jstep(jstate, jnp.asarray(img), jnp.asarray(ctx),
                       jnp.asarray(0.5, jnp.float32))
    tm = tstep(torch.from_numpy(img), torch.from_numpy(ctx), 0.5,
               noise=torch.from_numpy(noise))
    assert set(tm) == set(jm)
    assert abs(float(tm['loss']) - float(jm['loss'])) <= 1e-5
    for name in ('lb loss', 'router z', 'dropped', 'expert load'):
        assert _maxabs(_np(tm[name]), jm[name]) <= 1e-6, name
    named = dict(pipe.named_parameters())
    flipped = total = 0
    for name, ref in _grads_by_name(jstate['params']).items():
        diff = np.abs(_np(named[name]) - ref.numpy())
        flipped += int((diff > 1e-4).sum())
        total += diff.size
        assert float(diff[diff <= 1e-4].max(initial=0.0)) <= 1e-7, name
    assert flipped <= 1e-3 * total


# ---------------------------------------------------------------------------
# trainer, command lines (the engine: test_torch_serving.py)
# ---------------------------------------------------------------------------

class _SynthDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.random.default_rng(i).uniform(-1, 1, (32, 32, 3))
        return img.astype(np.float32), f'caption {i}'


def _fake_embedder(captions):
    return np.stack([np.random.default_rng(len(c)).standard_normal(
        (5, 48)).astype(np.float32) for c in captions])


def test_paintmind_trainer_trains_moe_pipeline(tmp_path, jparams):
    """JAX's ``test_paintmind_trainer_trains_moe_variant`` on the port: the
    trainer logs lb loss, router z, dropped and the expert load's max and
    min within their ranges, the router moves; ``save()`` ->
    ``resume('auto')`` into a second trainer gives the next loss bit for
    bit, the state file carrying the experts and their Lion moments."""
    def build(folder):
        return pt.PaintMindTrainer(
            make_pipe(jparams), _SynthDataset(20), num_epoch=1, valid_size=4,
            optim_name='lion', lr=1e-3, warmup_steps=1, decay_steps=10,
            batch_size=8, num_workers=2, grad_accum_steps=1,
            mixed_precision='no', save_every=100, sample_every=100,
            result_folder=str(folder), log_dir=str(folder / 'log'),
            text_embedder=_fake_embedder)
    first = build(tmp_path)
    router0 = first.model.transformer.layers[0].ffnet.router.weight.clone()
    first.train()
    assert first.steps == 2 and np.isfinite(first.log['loss'])
    assert not torch.equal(router0,
                           first.model.transformer.layers[0].ffnet.router.weight)
    for k in ('lb loss', 'router z', 'dropped', 'expert load max',
              'expert load min'):
        assert np.isfinite(first.log[k]), k
    assert 0.0 <= first.log['dropped'] <= 1.0
    assert 0.0 <= first.log['expert load min'] <= first.log['expert load max'] \
        <= 1.0
    state = torch.load(tmp_path / 'models' / 'paintmind_state_2.pt',
                       weights_only=False)
    assert 'transformer.layers.0.ffnet.experts.w12.weight' in state['model']
    batch = next(iter(first.train_dl))
    want = float(first.train_step(batch)['loss'])
    second = build(tmp_path).resume('auto')
    assert second.steps == 2
    assert float(second.train_step(batch)['loss']) == want
    for a, b in zip(first.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)


def test_moe_versions_build_and_dispatch():
    """``paintmindv1-moe`` and ``-moe-4e`` configure the MoE transformer at
    full width (E = 8 / 4, top-2, capacity factor 1.25, SwiGLU hidden
    2736), with JAX's defaults for what the registry does not say; a
    pipeline of the registry's tiny MoE version builds on the CPU."""
    for version, e in (('paintmindv1-moe', 8), ('paintmindv1-moe-4e', 4)):
        cfg = tpl.PipelineConfig.from_dict(pt.ver2cfg[version])
        jc = jpl.PipelineConfig.from_dict(jcfg.ver2cfg[version])
        assert isinstance(cfg.tcfg, tmt.MoECondTransformerConfig)
        for f in ('num_experts', 'num_selected', 'capacity_factor',
                  'moe_dispatch', 'lb_weight', 'zloss_weight', 'dim', 'depth',
                  'mlp_dim'):
            assert getattr(cfg.tcfg, f) == getattr(jc.tcfg, f), f
        assert cfg.num_experts == e and cfg.dim == 1024 and cfg.depth == 12
    pipe = pt.create_model('pipeline', 'torch-moe-pipeline', pretrained=False,
                           text_encoder=None, device='cpu')
    ffn = pipe.transformer.layers[1].ffnet
    assert ffn.experts.w12.weight.shape == (4, 96, 32)
    assert ffn.router.bias is None
    assert float(ffn.experts.w3.weight.abs().max()) > 0  # initialised


def test_train_paintmind_then_generate_moe(tmp_path, monkeypatch):
    """``train_paintmind --version torch-moe-pipeline`` -> ``generate`` on
    its export, in process on the CPU: the trainer trains the MoE pipeline
    and logs its routing metrics, and the export samples."""
    from PIL import Image

    from paintmind_tpu_torch.scripts import generate, train_paintmind
    data = tmp_path / 'jpegs'
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            data / f'img_{i:02d}.jpg')
    stage1 = str(tmp_path / 'vq.npz')
    pt.create_model('vqgan', 'torch-moe-vqgan', pretrained=False, device='cpu',
                    seed=3).save_pretrained(stage1)
    trainer = train_paintmind.main([
        '--dataset', f'folder:{data}', '--version', 'torch-moe-pipeline',
        '--stage1-checkpoint', stage1, '--batch-size', '2', '--grad-accum',
        '2', '--epochs', '1', '--valid-size', '4', '--save-every', '100',
        '--sample-every', '1000', '--num-workers', '2', '--mixed-precision',
        'no', '--device', 'cpu', '--result-folder', str(tmp_path / 'out'),
        '--log-dir', str(tmp_path / 'log')])
    assert isinstance(trainer.model.transformer, tmt.MoECondTransformer)
    assert trainer.steps == 4 and np.isfinite(trainer.log['loss'])
    assert 'expert load max' in trainer.log
    export = str(tmp_path / 'out' / 'models' / 'paintmind_step_4.npz')
    assert os.path.exists(export)

    def stand_in_tower(pipe):
        return lambda texts: torch.stack([torch.from_numpy(
            np.random.default_rng(len(t)).standard_normal((77, 1024)).astype(
                np.float32)) for t in texts])

    monkeypatch.setattr(tpl.Pipeline, '_get_text_model', stand_in_tower)
    imgs = generate.main(['a red house', 'a boat', '--checkpoint', export,
                          '--version', 'torch-moe-pipeline', '--timesteps',
                          '3', '--guidance-scale', '3.0', '--device', 'cpu',
                          '--out', str(tmp_path / 'samples.png')])
    assert imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
