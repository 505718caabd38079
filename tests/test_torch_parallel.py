"""The port's tensor, sequence, data and expert parallelism, ZeRO-1, int8
under tensor parallelism and the global-norm clipping, held against the JAX
package on the CPU.

Each world layout runs once, as gloo processes (``_torch_dist.run``, each
job with its own time limit), in a module-scoped fixture; the tests then
read its results.  The JAX references run here, on the conftest's virtual
devices, at the JAX tests' sizes: the ``PIPE`` configuration of
``tests/test_parallel.py`` and the small MoE layer of ``tests/test_moe.py``.
Inputs come from numpy seeds; parameters are JAX inits carried over by the
weight bridge.  Tolerances (fp32): 1e-5 max abs where a row-parallel sum
changes the summation order, as each test states.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import discriminator as jdisc
from paintmind_tpu.models import moe_transformer as jmt
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.models import transformer as jst2
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.nn import moe as jmoe
from paintmind_tpu.nn import quant as jquant
from paintmind_tpu.ops import flash_attention as jfa
from paintmind_tpu.train import steps as jsteps
from paintmind_tpu.utils.checkpoint import flatten_tree
from paintmind_tpu_torch.convert.from_jax import to_state_dict

from _torch_dist import ROOT, run, worker_env

SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
VQ_NAME = 'torch-par-vqgan'
jcfg.register_version(VQ_NAME, SMALL_VQ)
PIPE_KW = dict(stage1=VQ_NAME, t5='t5-l', dim=32, dim_head=16, mlp_dim=64,
               num_head=2, depth=2, dropout=0.0, t5_dim=48)
J_PIPE = jpl.PipelineConfig(vqc=jvm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)
L = J_PIPE.num_tokens


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rank_rows(outs, key, mp):
    """Concatenate each data rank's rows (model rank 0 of each group)."""
    return np.concatenate([o[key] for o in outs[::mp]])


@pytest.fixture(scope='module')
def jparams():
    return jpl.init_pipeline(jax.random.PRNGKey(0), J_PIPE)


@pytest.fixture(scope='module')
def tp_inputs(jparams):
    rng = np.random.default_rng(0)
    return {
        'register': {VQ_NAME: SMALL_VQ}, 'vq': SMALL_VQ, 'pipe_kw': PIPE_KW,
        'flat': _flat(jparams),
        'x': rng.standard_normal((4, 16, 8)).astype(np.float32),
        'ctx': rng.standard_normal((4, 5, 48)).astype(np.float32),
        'img': rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
        **{n: rng.standard_normal((4, 128, 4, 16)).astype(np.float32)
           for n in ('q', 'k', 'v')},
    }


@pytest.fixture(scope='module')
def tp_refs(jparams, tp_inputs):
    i = tp_inputs
    x, ctx = jnp.asarray(i['x']), jnp.asarray(i['ctx'])
    logits = jst2.cond_transformer_apply(jparams['transformer'], x, ctx,
                                         cfg=J_PIPE.tcfg, backend='xla')
    rec, loss = jvm.forward(jparams['vqgan'], jnp.asarray(i['img']),
                            J_PIPE.vqc, backend='xla', vq_backend='xla')
    attn = jfa._xla_reference(*(jnp.asarray(i[n]) for n in 'qkv'), 0.25)
    q_logits = {}
    for mode in ('w8a8', 'w8'):
        tp = dict(jparams['transformer'])
        tp['layers'] = jquant.quantize_tree(tp['layers'], mode, min_dim=16)
        tp['to_logits'] = jquant.quantize_linear(tp['to_logits'], mode)
        q_logits[mode] = jst2.cond_transformer_apply(tp, x, ctx,
                                                     cfg=J_PIPE.tcfg,
                                                     backend='xla')
    return {k: np.asarray(v) for k, v in dict(
        logits=logits, rec=rec, vq_loss=loss, attn=attn,
        q_logits=q_logits['w8a8'], q_logits_w8=q_logits['w8']).items()}


# (data, model) layouts of the tensor-parallel job
TP_LAYOUTS = [(1, 2), (2, 2)]


@pytest.fixture(scope='module')
def tp_runs(tp_inputs):
    return {(dp, mp): run('tp', dp * mp, tp_inputs, model_parallel=mp)
            for dp, mp in TP_LAYOUTS}


@pytest.mark.parametrize('layout', TP_LAYOUTS)
def test_tp_stage2_logits_match_jax(tp_runs, tp_refs, layout):
    """``test_parallel.py:44``: carved stage-2 logits within 1e-5 max abs of
    JAX's unsharded apply (the row-parallel sums change the order)."""
    got = _rank_rows(tp_runs[layout], 'logits', layout[1])
    assert _maxabs(got, tp_refs['logits']) < 1e-5


@pytest.mark.parametrize('layout', TP_LAYOUTS)
def test_tp_vqgan_forward_matches_jax(tp_runs, tp_refs, layout):
    """``test_parallel.py:62``: the carved VQGAN's reconstruction within
    1e-5 and its commitment loss (mean of the data ranks') within 1e-5."""
    outs = tp_runs[layout]
    assert _maxabs(_rank_rows(outs, 'rec', layout[1]), tp_refs['rec']) < 1e-5
    loss = np.mean([o['vq_loss'] for o in outs[::layout[1]]])
    assert abs(loss - float(tp_refs['vq_loss'])) < 1e-5


@pytest.mark.parametrize('layout', TP_LAYOUTS)
def test_tp_k1_plain_on_local_heads(tp_runs, tp_refs, layout):
    """``test_parallel.py:144``: K1's plain path on each rank's heads gives
    those heads of the whole attention (1e-5)."""
    dp, mp = layout
    outs = tp_runs[layout]
    got = np.concatenate([
        np.concatenate([outs[d * mp + m]['attn'] for m in range(mp)], axis=2)
        for d in range(dp)])
    assert _maxabs(got, tp_refs['attn']) < 1e-5


@pytest.mark.parametrize('layout', TP_LAYOUTS)
def test_tp_int8_w8a8_logits_match_jax(tp_runs, tp_refs, layout):
    """``test_quant.py:110``: a w8a8 transformer, quantized whole and then
    carved, within 1e-5 of JAX's quantized logits; the global amax and the
    exact int32 sums make it equal the unsharded port layer to 1e-5."""
    outs = tp_runs[layout]
    got = _rank_rows(outs, 'q_logits', layout[1])
    assert _maxabs(got, tp_refs['q_logits']) < 1e-5
    assert _maxabs(got, _rank_rows(outs, 'q_logits_unsharded',
                                   layout[1])) < 1e-5


@pytest.mark.parametrize('layout', TP_LAYOUTS)
@pytest.mark.parametrize('mode', ['w8a8', 'w8'])
def test_tp_shard_then_quantize_matches_quantize(tp_runs, tp_refs, layout,
                                                 mode):
    """``quantize()`` after ``shard()``, as the JAX package allows (its
    ``quantize`` works on global arrays): the gathered int8 tree equals the
    unsharded ``quantize(mode)`` bit for bit, each rank's tensors equal
    ``quantize(mode).shard(mesh)``'s, and the logits are within the w8a8
    test's 1e-5 of JAX's quantized logits."""
    outs = tp_runs[layout]
    for o in outs:
        assert o[f'sq_{mode}']['full_equal'] and o[f'sq_{mode}']['local_equal']
    got = np.concatenate([o[f'sq_{mode}']['logits'] for o in outs[::layout[1]]])
    want = tp_refs['q_logits' if mode == 'w8a8' else 'q_logits_w8']
    assert _maxabs(got, want) < 1e-5


@pytest.mark.parametrize('layout', TP_LAYOUTS)
def test_sequence_parallel_logits_and_sampler(tp_runs, tp_refs, layout):
    """``test_parallel.py:78``: sequence-parallel logits within 1e-5 of JAX;
    the sampler loop's ids under SP and TP equal the unplaced ones."""
    outs = tp_runs[layout]
    assert _maxabs(_rank_rows(outs, 'sp_logits', layout[1]),
                   tp_refs['logits']) < 1e-5
    for o in outs:
        np.testing.assert_array_equal(o['ids_sp'], o['ids_ref'])
        np.testing.assert_array_equal(o['ids_tp'], o['ids_ref'])


@pytest.mark.parametrize('layout', TP_LAYOUTS)
def test_clip_by_global_norm_under_tp(tp_runs, layout):
    """Clipping that engages (max norm 1e-3): the norm over the carved
    transformer within 1e-6 relative of the unsharded norm, the clipped
    gradients gathered whole within 1e-9 of the unsharded ones; the
    gathered state dict equals the unplaced weights."""
    for o in tp_runs[layout]:
        assert o['norm_ref'] > 1e-3
        assert abs(o['norm'] - o['norm_ref']) <= 1e-6 * o['norm_ref']
        assert o['clip_err'] < 1e-9
        assert o['full_equal']
        assert o['counts']['all_reduce'] > 0 and o['counts']['all_gather'] > 0


# ---------------------------------------------------------------------------
# data parallelism, ZeRO-1, DP-MoE, sync-BN
# ---------------------------------------------------------------------------

def _jax_noise(key, b):
    key, k_step = jax.random.split(key)
    k_mask, _ = jax.random.split(jax.random.split(k_step, 1)[0])
    return np.array(jax.random.uniform(k_mask, (b, L)))


J_DCFG = jdisc.DiscriminatorConfig(input_nc=3, ndf=8, n_layers=3)
MOE_CF = 1.0  # top-2 over 4 experts at factor 1: some assignments drop


@pytest.fixture(scope='module')
def dp_setup(jparams):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    ctx = rng.standard_normal((8, 5, 48)).astype(np.float32)
    ratio = jnp.asarray(0.7, jnp.float32)
    refs = {}
    for name, opt in (
            ('adamw', optax.chain(optax.clip_by_global_norm(1.0),
                                  optax.adamw(1e-3, b1=0.9, b2=0.96,
                                              weight_decay=0.05))),
            ('lion', optax.chain(optax.clip_by_global_norm(1.0),
                                 optax.lion(1e-3, b1=0.9, b2=0.99,
                                             weight_decay=0.0)))):
        tx = jsteps.masked_tx(opt, jparams)
        s = jsteps.init_pipeline_train_state(jax.random.PRNGKey(3), jparams,
                                             tx)
        noise = _jax_noise(s['key'], 8)
        s, m = jax.jit(jsteps.make_pipeline_train_step(
            J_PIPE, tx, backend='xla'))(s, jnp.asarray(img), jnp.asarray(ctx),
                                        ratio)
        refs[name] = (float(m['loss']), to_state_dict(flatten_tree(
            {'transformer': s['params']['transformer'],
             'mask_token': s['params']['mask_token']})))
    # the routed layer on the global tokens, with capacity drops
    p = jmoe.init_moe_swiglu(jax.random.PRNGKey(5), 16, 32, num_experts=4)
    mx = rng.standard_normal((4, 6, 16)).astype(np.float32)
    y, aux = jmoe.moe_swiglu(p, jnp.asarray(mx), num_selected=2,
                             capacity_factor=MOE_CF, dispatch='gather')
    refs['moe'] = (np.asarray(y), {k: np.asarray(v) for k, v in aux.items()})
    # the stage-1 step on the global batch (sync-BN statistics)
    jtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(1e-3, b1=0.9, b2=0.99))
    vq = jvm.init_vqmodel(jax.random.PRNGKey(6), J_PIPE.vqc)
    js = jsteps.init_vqgan_train_state(jax.random.PRNGKey(1), vq, jtx, jtx,
                                       J_DCFG)
    vimg = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    k_step = jax.random.split(js['key'])[1]
    eta = np.asarray(jax.random.uniform(jax.random.split(k_step, 1)[0],
                                        (4, 1, 1, 1)))
    d_params, d_stats = js['d_params'], js['d_stats']
    js2, jm = jax.jit(jsteps.make_vqgan_train_step(
        J_PIPE.vqc, jtx, jtx, dcfg=J_DCFG, backend='xla'))(js, jnp.asarray(vimg))
    refs['vqgan'] = ({k: float(v) for k, v in jm.items()},
                     to_state_dict(flatten_tree(js2['g_params'])), js2)
    inputs = {
        'register': {VQ_NAME: SMALL_VQ}, 'vq': SMALL_VQ, 'pipe_kw': PIPE_KW,
        'flat': _flat(jparams), 'img': img, 'ctx': ctx,
        'noise': _jax_noise(jax.random.PRNGKey(3), 8),
        'moe_flat': _flat(p), 'moe_x': mx, 'moe_cf': MOE_CF,
        'vq_flat': _flat(vq), 'vq_img': vimg, 'eta': eta,
        'd_params': jax.tree_util.tree_map(np.asarray, d_params),
        'd_stats': jax.tree_util.tree_map(np.asarray, d_stats),
    }
    return inputs, refs


@pytest.fixture(scope='module')
def dp_runs(dp_setup):
    inputs, _ = dp_setup
    return {dp: run('dp', dp, inputs) for dp in (2, 4)}


def _close_state(got, want, tol, flips=0.0):
    """Every trainable tensor within ``tol`` max abs; with ``flips``, that
    share of the entries may differ by a sign flip of a Lion step."""
    bad = total = 0
    for name, ref in want.items():
        d = np.abs(got[name] - ref.numpy())
        bad += int((d > tol).sum())
        total += d.size
    assert bad <= flips * total, (bad, total)


@pytest.mark.parametrize('dp', [2, 4])
def test_dp_train_step_matches_jax_single_device(dp_runs, dp_setup, dp):
    """``test_parallel.py:112``: one AdamW update (clipping at 1.0) of the
    data-parallel step on the ranks' rows: the loss and the updated weights
    within 1e-5 of JAX's one-device step on the global batch."""
    loss, want = dp_setup[1]['adamw']
    for o in dp_runs[dp]:
        assert abs(o['loss'] - loss) < 1e-5
        _close_state(o['adamw'], want, 1e-5)
        assert o['counts']['all_reduce'] > 0


def test_zero1_matches_replicated_and_jax(dp_runs, dp_setup):
    """``test_parallel.py:278``: ZeRO-1 at dp 2 (min size 256: some moments
    really sliced), two Lion updates: the gathered weights and moments
    within 1e-6 of the port's replicated data-parallel steps."""
    for o in dp_runs[2]:
        zl, zw, zm, sliced = o['zero']
        rl, rw, rm, none = o['replicated']
        assert sliced > 0 and none == 0
        assert abs(zl - rl) < 1e-6
        for name in rw:
            assert _maxabs(zw[name], rw[name]) < 1e-6, name
            assert _maxabs(zm[name], rm[name]) < 1e-6, name
        assert o['counts']['reduce_scatter'] > 0


def test_zero1_one_update_matches_jax(dp_setup):
    """ZeRO-1 at dp 2 against JAX's ZeRO step (``test_parallel.py:278``,
    which equals its replicated step): one Lion update, the loss within
    1e-5 and the weights within 1e-5 (a Lion sign flip moves an entry by
    2e-3: at most 0.1 % may)."""
    inputs, refs = dp_setup
    outs = run('zero1', 2, inputs)
    loss, want = refs['lion']
    for o in outs:
        assert o['sliced'] > 0
        assert abs(o['loss'] - loss) < 1e-5
        _close_state(o['weights'], want, 1e-5, flips=1e-3)


def test_dp_moe_routes_the_global_batch_with_drops(dp_runs, dp_setup):
    """The routed layer at dp 2 with capacity drops: each rank places its
    assignments in the global slot order, so the outputs equal JAX's
    routing of the global batch (1e-5), the dropped share exactly, the
    load-balance loss within 1e-6; the kept assignments equal the port's
    own global routing."""
    import torch
    from paintmind_tpu_torch.nn import moe as tmoe
    from paintmind_tpu_torch.convert.from_jax import load_jax_params
    y_ref, aux_ref = dp_setup[1]['moe']
    outs = dp_runs[2]
    assert aux_ref['dropped'] > 0
    y = np.concatenate([o['moe_y'] for o in outs])
    assert _maxabs(y, y_ref) < 1e-5
    for o in outs:
        assert float(o['moe_aux']['dropped']) == float(aux_ref['dropped'])
        assert abs(float(o['moe_aux']['lb_loss'])
                   - float(aux_ref['lb_loss'])) < 1e-6
        assert _maxabs(o['moe_aux']['expert_load'],
                       aux_ref['expert_load']) < 1e-6
    layer = load_jax_params(tmoe.MoESwiGLU(16, 32, 4, device='cpu'),
                            dp_setup[0]['moe_flat'])
    xt = torch.from_numpy(dp_setup[0]['moe_x']).reshape(-1, 16)
    *_, keep, cap = tmoe.route(layer, xt, 2, MOE_CF)
    assert outs[0]['moe_cap'] == cap
    np.testing.assert_array_equal(
        np.concatenate([o['moe_keep'] for o in outs]), keep.numpy())


def test_sync_bn_vqgan_step_matches_jax(dp_runs, dp_setup):
    """The stage-1 step at dp 2 (each rank 2 of the 4 images): the
    discriminator's BatchNorm takes the global batch's statistics, so the
    metrics are within 1e-5 relative and the VQGAN's weights and D's
    parameters and running statistics within 2e-5 mean abs of JAX's step
    on the whole batch."""
    import torch
    from paintmind_tpu_torch.models import discriminator as tdisc
    from test_torch_vqgan import _disc_flat, discriminator_to_flat
    jm, want, js = dp_setup[1]['vqgan']
    jflat = _disc_flat(js['d_params'], js['d_stats'])
    for o in dp_runs[2]:
        got = o['vqgan']
        for k, v in jm.items():
            assert abs(got['metrics'][k] - v) <= 1e-5 * max(abs(v), 1e-3), k
        for name, ref in want.items():
            assert float(np.abs(got['g'][name] - ref.numpy()).mean()) <= 2e-5
        d = tdisc.Discriminator(tdisc.DiscriminatorConfig(
            input_nc=3, ndf=8, n_layers=3), device='cpu')
        d.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got['d'].items()})
        for t, j in zip(discriminator_to_flat(d), jflat):
            assert t.keys() == j.keys()
            for k in j:
                assert float(np.abs(t[k] - j[k]).mean()) <= 2e-5, k


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

EP_CFG = dict(in_dim=8, dim=16, len_seq=16, dim_head=4, mlp_dim=32,
              num_head=4, depth=2, dropout=0.0, context_dim=24,
              num_classes=64, num_experts=8, num_selected=2,
              capacity_factor=2.0)


@pytest.fixture(scope='module')
def ep_run():
    cfg = jmt.MoECondTransformerConfig(**EP_CFG)
    params = jmt.init_moe_cond_transformer(jax.random.PRNGKey(4), cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((4, 5, 24)).astype(np.float32)
    ref, aux = jmt.moe_cond_transformer_apply(params, jnp.asarray(x),
                                              jnp.asarray(ctx), cfg=cfg,
                                              backend='xla')
    outs = run('ep', 4, {'cfg': EP_CFG, 'flat': _flat(params), 'x': x,
                         'ctx': ctx}, model_parallel=4)
    return outs, np.asarray(ref), {k: np.asarray(v) for k, v in aux.items()}


def test_ep_logits_and_lb_loss_match_jax(ep_run):
    """``test_moe.py:94`` at (dp 1, model 4): each rank holds 2 of the 8
    experts, 'auto' dispatch is dense, the combine an all-reduce; logits
    within 1e-4 and the load-balance loss within 1e-5 of JAX."""
    outs, ref, aux = ep_run
    for o in outs:
        assert o['local_experts'] == 2
        assert _maxabs(o['logits'], ref) < 1e-4
        assert abs(float(o['aux']['lb_loss']) - float(aux['lb_loss'])) < 1e-5
        assert o['counts']['all_reduce'] > 0


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def test_multihost_initialize_single_process():
    """``test_parallel.py:367``'s counterpart: initialize() with an explicit
    coordinator at world size 1 on gloo returns JAX's keys, rank 0 is the
    main process, a mesh has one rank; without torchrun's environment and
    without arguments it raises; 'cuda' without a card raises (no fallback
    to gloo)."""
    code = """
import os, torch
from paintmind_tpu_torch.parallel import multihost, mesh
for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
    os.environ.pop(k, None)
try:
    multihost.initialize(device='cpu')
except ValueError as e:
    assert 'torchrun' in str(e)
else:
    raise AssertionError('no error without the environment')
if not torch.cuda.is_available():
    try:
        multihost.initialize(device='cuda')
    except RuntimeError as e:
        assert 'no CUDA' in str(e)
    else:
        raise AssertionError('cuda without a card')
assert multihost.is_main_process()
info = multihost.initialize('127.0.0.1:%d', 1, 0, device='cpu')
assert info == {'process_index': 0, 'process_count': 1, 'local_devices': 1,
                'global_devices': 1}, info
assert multihost.is_main_process()
m = mesh.make_mesh()
assert m.shape == {'data': 1, 'model': 1} and str(m.device) == 'cpu'
multihost.shutdown()
print('MULTIHOST_OK')
"""
    from _torch_dist import free_port
    out = subprocess.run([sys.executable, '-c', code % free_port()],
                         capture_output=True, text=True, timeout=120,
                         env=worker_env(), cwd=ROOT)
    assert 'MULTIHOST_OK' in out.stdout, (out.stdout, out.stderr)
