"""The port's stage-2 training path held against the JAX package on the CPU.

Small configuration (depth 2, dim 32, 2 heads of 16, 32² images, t5_dim 48 so
``context_proj`` runs); the flash-attention backward is checked at head dim 64,
the only one its kernel takes.  Inputs come from numpy seeds; parameters are
JAX inits carried over by the weight bridge; the masking noise is the noise
the JAX functions draw from their keys, handed to the port, so both sides
mask the same tokens.  Tolerances are stated in each test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.ops import flash_attention as jfa
from paintmind_tpu.train import steps as jsteps
from paintmind_tpu.utils.checkpoint import flatten_tree
import paintmind_tpu_torch as pt
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.convert.from_jax import load_jax_params, \
    to_flat, to_state_dict
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.nn import core as tcore
from paintmind_tpu_torch.ops import flash_attention as tfa
from paintmind_tpu_torch.train import steps as tsteps
from paintmind_tpu_torch.utils import data as tdata
from paintmind_tpu_torch.utils import trainer as ttrainer

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
jcfg.register_version('torch-port-train-vqgan', SMALL_VQ)
tcfg.register_version('torch-port-train-vqgan', SMALL_VQ)
PIPE_KW = dict(stage1='torch-port-train-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, depth=2, t5_dim=48)
J_PIPE = jpl.PipelineConfig(vqc=jvm.VQModelConfig.from_dict(SMALL_VQ),
                            dropout=0.0, **PIPE_KW)


def t_cfg(dropout=0.0):
    return tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(SMALL_VQ),
                              dropout=dropout, **PIPE_KW)


L = J_PIPE.num_tokens


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _images(seed, b):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, 32, 32, 3)).astype(np.float32)


def _context(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 5, 48)).astype(np.float32)


@pytest.fixture(scope='module')
def jparams():
    return jpl.init_pipeline(jax.random.PRNGKey(0), J_PIPE)


def make_pipe(jparams, dropout=0.0):
    pipe = tpl.Pipeline(t_cfg(dropout), stage1_pretrained=False,
                        text_encoder=None, device='cpu')
    return load_jax_params(pipe, flatten_tree(jparams))


# ---------------------------------------------------------------------------
# K4's plain version and the autograd wiring
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret_mode():
    # the jitted wrapper caches per shape: the shapes below are used by no
    # other test, so the flag is read when they are traced
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _qkvg(n, m, dtype=np.float32):
    rng = np.random.default_rng(n * 1000 + m)
    return [rng.standard_normal((2, rows, 3, 64)).astype(dtype)
            for rows in (n, m, m, n)]


@pytest.mark.parametrize('n,m', [(128, 77), (200, 77), (72, 72)])
def test_flash_backward_plain_fp32(interpret_mode, n, m):
    """``flash_attention_backward_plain`` against (a) the Pallas backward in
    interpret mode, (b) ``jax.grad`` of the einsum reference, (c) torch
    autograd of ``flash_attention_plain``, at M = 77 and ragged N: mean
    relative error < 1e-5 per gradient in fp32."""
    q, k, v, g = _qkvg(n, m)
    scale = 0.125
    got = tfa.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, g)), scale)
    pallas = jfa._flash_backward(*(jnp.asarray(a) for a in (q, k, v, g)),
                                 scale)
    _, vjp = jax.vjp(lambda a, b, c: jfa._xla_reference(a, b, c, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xla = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    auto = torch.autograd.grad(tfa.flash_attention_plain(*leaves, scale),
                               leaves, torch.from_numpy(g))
    for name, a, p, x, t in zip(('dq', 'dk', 'dv'), got, pallas, xla, auto):
        assert a.shape == t.shape and a.dtype == torch.float32
        assert _rel(_np(a), p) < 1e-5, (name, 'pallas interpret')
        assert _rel(_np(a), x) < 1e-5, (name, 'jax.grad')
        assert _rel(_np(a), _np(t)) < 1e-5, (name, 'torch autograd')


def test_flash_backward_plain_bf16(interpret_mode):
    """bf16 operands: the plain version rounds P and dS to bf16 before the
    products that consume them, as kernel K4 and the Pallas kernel
    (``_bwd_kernel``) do, and forms delta and dS in fp32 as they do; what is
    left between it and the Pallas kernel is the order of the fp32 sums
    moving a rounding here and there: mean relative error < 1e-4 per
    gradient (measured 2.2e-7 at most; the gate was 2e-2 and the distance
    1.6e-3 while the plain version kept P and dS in fp32).  Within 1e-2 of
    its own fp32 result on the same (bf16-valued) inputs (measured
    2.2e-3)."""
    scale = 0.125
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in _qkvg(136, 77))
    got = tfa.flash_attention_backward_plain(q, k, v, g, scale)
    exact = tfa.flash_attention_backward_plain(q.float(), k.float(), v.float(),
                                               g.float(), scale)
    pallas = jfa._flash_backward(
        *(jnp.asarray(_np(a.float()), jnp.bfloat16) for a in (q, k, v, g)),
        scale)
    for name, a, e, p in zip(('dq', 'dk', 'dv'), got, exact, pallas):
        assert a.dtype == torch.bfloat16
        print(f'plain K4 bf16 {name}: vs Pallas (interpret) '
              f'{_rel(_np(a.float()), np.asarray(p, np.float32)):.3e}, vs its '
              f'fp32 result {_rel(_np(a.float()), _np(e)):.3e}')
        assert _rel(_np(a.float()), np.asarray(p, np.float32)) < 1e-4
        assert _rel(_np(a.float()), _np(e)) < 1e-2


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n,m', [(200, 77), (128, 77), (72, 72), (128, 192)])
def test_flash_backward_tiled_emulation(interpret_mode, n, m, dtype):
    """The tiled emulation of the bf16 K4 (64-key tiles, P = 0 on the columns
    past M, zero rows and lse = 0 past N, base-2 exponent from the tiled
    forward's log-sum-exp, a delta pass and a dS pass over the same P and dP,
    P and dS rounded before their products) against
    ``flash_attention_backward_plain`` and the Pallas backward in interpret
    mode.  fp32: mean relative error <= 1e-5 per gradient.  bf16: <= 1e-4
    against either, since both round at the same places (measured 5.2e-6
    at most: a P, a dS or a gradient that lands on the other side of a
    bf16 rounding because the fp32 sums ran in another order)."""
    scale = 0.125
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in _qkvg(n + 1000, m))
    q, g = q[:, :n], g[:, :n]
    lse = tfa.flash_attention_tiled(q, k, v, scale)[1]
    got = tfa.flash_attention_backward_tiled(q, k, v, g, scale, lse)
    plain = tfa.flash_attention_backward_plain(q, k, v, g, scale)
    pallas = jfa._flash_backward(
        *(jnp.asarray(_np(a.float()), getattr(jnp, dtype))
          for a in (q, k, v, g)), scale)
    tol_plain, tol_pallas = (1e-5, 1e-5) if dtype == 'float32' else (1e-4, 1e-4)
    for name, a, w, p in zip(('dq', 'dk', 'dv'), got, plain, pallas):
        assert a.shape == w.shape and a.dtype == tdt
        r_plain = _rel(_np(a.float()), _np(w.float()))
        r_pallas = _rel(_np(a.float()), np.asarray(p, np.float32))
        print(f'tiled K4 {name} N={n} M={m} {dtype}: vs plain {r_plain:.3e}, '
              f'vs Pallas (interpret) {r_pallas:.3e}')
        assert r_plain <= tol_plain, name
        assert r_pallas <= tol_pallas, name


def test_flash_attention_function_on_cpu():
    """The ``autograd.Function`` is what a differentiable call goes through
    (its backward is the plain backward on the CPU, kernel K4 on the card):
    the result hangs on its inputs, the gradients are the plain backward's
    bits, ``gradcheck`` passes in fp64, and without grad mode or without a
    differentiable operand there is no graph."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(40, 9))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, 0.125)
    assert type(out.grad_fn).__name__ == '_FlashAttentionBackward'
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v, 0.125))
    auto = torch.autograd.grad(out, leaves, g)
    want = tfa.flash_attention_backward_plain(q, k, v, g, 0.125)
    assert all(torch.equal(a, w) for a, w in zip(auto, want))
    # only k differentiable: q and v get no gradient, k the same one
    kk = k.clone().requires_grad_(True)
    (dk,) = torch.autograd.grad(tfa.flash_attention(q, kk, v, 0.125), [kk], g)
    assert torch.equal(dk, want[1])
    with torch.no_grad():
        assert tfa.flash_attention(*leaves, 0.125).grad_fn is None
    assert tfa.flash_attention(q, k, v, 0.125).grad_fn is None
    small = [torch.from_numpy(a[:1, :, :2]).double().requires_grad_(True)
             for a in _qkvg(6, 5)[:3]]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, 0.125), small)
    # a cotangent that is not contiguous is taken as it comes
    gt = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert not gt.is_contiguous()
    auto2 = torch.autograd.grad(tfa.flash_attention(*leaves, 0.125), leaves, gt)
    assert all(torch.equal(a, w) for a, w in zip(auto2, want))


# ---------------------------------------------------------------------------
# dropout, masking, loss
# ---------------------------------------------------------------------------

def test_dropout_keep_rate_scaling_and_eval_identity():
    x = torch.ones(400, 500)
    g = torch.Generator().manual_seed(0)
    y = tcore.dropout(x, 0.1, generator=g, training=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 5e-3
    assert torch.allclose(y[kept], torch.tensor(1.0 / 0.9))
    assert tcore.dropout(x, 0.1, generator=g, training=False) is x
    assert tcore.dropout(x, 0.0, generator=g, training=True) is x
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(y, tcore.dropout(x, 0.1, generator=g2, training=True))


@pytest.mark.parametrize('ratio', [0.75, 0.5, 0.3, 0.7, 1.0 / 16, 0.001,
                                   0.9999999, 0.4375, 0.31250003])
def test_random_masking_bit_equal(ratio):
    """On the uniform noise JAX draws, the mask and the masked tokens are
    bit-equal, for ratios on and next to a boundary of L·ratio (L = 16) and
    for ratios that floor to 0 (at least one token is masked)."""
    key = jax.random.PRNGKey(int(ratio * 1e6))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, L, 8)).astype(np.float32)
    tok = rng.standard_normal((1, 8)).astype(np.float32)
    jx, jmask = jpl.random_masking(key, jnp.asarray(x), jnp.asarray(tok),
                                   jnp.asarray(ratio, jnp.float32))
    noise = np.array(jax.random.uniform(key, (3, L)))
    tx, tmask = tpl.random_masking(torch.from_numpy(x), torch.from_numpy(tok),
                                   ratio, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(_np(tmask), np.asarray(jmask))
    np.testing.assert_array_equal(_np(tx), np.asarray(jx))
    assert tmask.sum(1).tolist() == [max(int(np.float32(L) * np.float32(ratio)),
                                         1)] * 3


def test_random_masking_ties_and_generator():
    """Equal noise values rank in index order (stable sort, as jnp.argsort);
    without ``noise`` the numbers come from the generator."""
    noise = np.zeros((2, L), np.float32)
    noise[1, ::2] = 0.5
    x = np.zeros((2, L, 8), np.float32)
    tok = np.ones((1, 8), np.float32)
    key = jax.random.PRNGKey(0)
    ids_shuffle = jnp.argsort(jnp.asarray(noise), axis=1)
    keep = np.asarray(jnp.argsort(ids_shuffle, axis=1) < L - 4)
    _, tmask = tpl.random_masking(torch.from_numpy(x), torch.from_numpy(tok),
                                  0.25, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(_np(tmask), 1.0 - keep)
    del key
    g = torch.Generator().manual_seed(3)
    _, m1 = tpl.random_masking(torch.from_numpy(x), torch.from_numpy(tok),
                               0.5, generator=g)
    _, m2 = tpl.random_masking(torch.from_numpy(x), torch.from_numpy(tok), 0.5,
                               generator=torch.Generator().manual_seed(3))
    assert torch.equal(m1, m2) and m1.sum(1).tolist() == [L // 2] * 2


def test_masked_ce_loss_matches_jax():
    """Label-smoothed masked CE: the value within 1e-5 (it is 8.7, where one
    fp32 ulp is 9.5e-7), its gradient within 1e-6."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, L, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 64, (2, L)).astype(np.int32)
    mask = (rng.random((2, L)) > 0.4).astype(np.float32)
    jl, jg = jax.value_and_grad(jpl.masked_ce_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    tl_in = torch.from_numpy(logits).requires_grad_(True)
    loss = tpl.masked_ce_loss(tl_in, torch.from_numpy(labels),
                              torch.from_numpy(mask))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert float(np.abs(_np(tl_in.grad) - np.asarray(jg)).max()) <= 1e-6
    bf = tpl.masked_ce_loss(torch.from_numpy(logits).bfloat16(),
                            torch.from_numpy(labels), torch.from_numpy(mask))
    assert bf.dtype == torch.float32 and abs(float(bf) - float(jl)) < 5e-2


def _jax_noise(key, b):
    """The masking noise ``jpl.pipeline_loss`` draws from ``key``."""
    k_mask, _ = jax.random.split(key)
    return np.array(jax.random.uniform(k_mask, (b, L)))


def _grads_by_name(jgrads):
    """JAX gradient tree of the trainable half -> {torch parameter name}."""
    flat = flatten_tree({'transformer': jgrads['transformer'],
                         'mask_token': jgrads['mask_token']})
    return to_state_dict(flat)


@pytest.mark.parametrize('with_context', [True, False])
def test_pipeline_loss_and_gradients_match_jax(jparams, with_context):
    """``pipeline_loss`` on JAX's masking noise, dropout 0: the loss within
    1e-5 and the gradient of every trainable leaf within 1e-4 mean relative
    error of ``jax.grad`` of the JAX loss, with and without a context; the
    VQGAN gets no gradient."""
    b = 3
    img, ctx = _images(2, b), _context(3, b) if with_context else None
    key = jax.random.PRNGKey(11)
    ratio = 0.6

    def jloss(p):
        return jpl.pipeline_loss(
            p, jnp.asarray(img), None if ctx is None else jnp.asarray(ctx),
            jnp.asarray(ratio, jnp.float32), key, cfg=J_PIPE,
            deterministic=False, backend='xla')

    jl, jg = jax.value_and_grad(jloss)(jparams)
    pipe = make_pipe(jparams)
    for p in pipe.trainable_parameters():
        p.requires_grad_(True)
    pipe.train()
    loss = tpl.pipeline_loss(
        pipe, torch.from_numpy(img),
        None if ctx is None else torch.from_numpy(ctx), ratio,
        noise=torch.from_numpy(_jax_noise(key, b)))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    want = _grads_by_name(jg)
    named = dict(pipe.named_parameters())
    checked = 0
    for name, ref in want.items():
        grad = named[name].grad
        if not with_context and ('context_proj' in name):
            assert grad is None  # the context projection did not run
            continue
        assert grad is not None, name
        assert _rel(_np(grad), ref.numpy()) <= 1e-4, name
        checked += 1
    assert checked >= len(want) - 1
    assert all(p.grad is None for p in pipe.vqgan.parameters())
    assert not pipe.vqgan.training and pipe.transformer.training


def test_pipeline_forward_api(jparams):
    """``Pipeline.forward`` / ``__call__`` give the training loss;
    ``tokens2logits`` and ``ids2tokens`` match the JAX object's functions."""
    pipe = make_pipe(jparams)
    img = _images(5, 2)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        loss = pipe(img, text=_context(6, 2), mask_ratio=0.5, generator=g)
    assert loss.ndim == 0 and np.isfinite(float(loss))
    assert abs(float(loss) - np.log(64)) < 1.0  # near ln(vocab) at init
    tokens = np.random.default_rng(7).standard_normal((2, L, 8)).astype(np.float32)
    ref = jpl.cond_transformer_apply(jparams['transformer'], jnp.asarray(tokens),
                                     None, cfg=J_PIPE.tcfg, backend='xla')
    with torch.no_grad():
        got = pipe.tokens2logits(tokens)
    assert float(np.abs(_np(got) - np.asarray(ref)).max()) <= 1e-5
    ids = np.asarray([[0, 5, J_PIPE.mask_token_id] + [1] * (L - 3)], np.int32)
    np.testing.assert_array_equal(
        _np(pipe.ids2tokens(ids)),
        np.asarray(jpl.ids_to_tokens(jparams, jnp.asarray(ids), J_PIPE)))


def test_remat_matches_plain_backward_with_dropout(jparams):
    """``remat=True`` (a checkpoint per block) with dropout on: the same
    loss, the same gradients and the same generator state afterwards as
    without it, so the recomputation saw the masks of the first run."""
    img, ctx = torch.from_numpy(_images(8, 2)), torch.from_numpy(_context(9, 2))
    results = []
    for remat in (False, True):
        pipe = make_pipe(jparams, dropout=0.3)
        for p in pipe.trainable_parameters():
            p.requires_grad_(True)
        pipe.train()
        g = torch.Generator().manual_seed(5)
        loss = tpl.pipeline_loss(pipe, img, ctx, 0.5, generator=g, remat=remat)
        loss.backward()
        results.append((float(loss.detach()), [p.grad.clone() for p in
                                      pipe.trainable_parameters()],
                        g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == l1 and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    # and dropout really ran: another seed gives another loss
    pipe.zero_grad()
    other = tpl.pipeline_loss(pipe, img, ctx, 0.5,
                              generator=torch.Generator().manual_seed(6))
    assert float(other.detach()) != l0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_step_noise(key, grad_accum, micro):
    """The per-microbatch masking noise one JAX train step draws, and the
    key it leaves in the state."""
    key, k_step = jax.random.split(key)
    keys = jax.random.split(k_step, grad_accum)
    return key, np.concatenate([_jax_noise(k, micro) for k in keys])


@pytest.mark.parametrize('grad_accum', [1, 2])
def test_three_updates_match_jax_adamw(jparams, grad_accum):
    """Three updates of the whole step (AdamW, clipping at 1.0, EMA 0.9)
    against ``make_pipeline_train_step`` on the same batches and masking
    noise: each loss within 1e-4, the trained weights and their EMA within
    2e-5 mean abs (Adam's normalised update amplifies rounding where the
    second moment is tiny, hence looser than the gradients'), the VQGAN
    bit-equal to its start."""
    b, lr = 4, 1e-3
    tx = jsteps.masked_tx(optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(lr, b1=0.9, b2=0.96, weight_decay=0.05)), jparams)
    jstate = jsteps.init_pipeline_train_state(jax.random.PRNGKey(4), jparams,
                                              tx, ema_decay=0.9)
    jstep = jax.jit(jsteps.make_pipeline_train_step(
        J_PIPE, tx, grad_accum=grad_accum, backend='xla', ema_decay=0.9))
    pipe = make_pipe(jparams)
    vq0 = [p.clone() for p in pipe.vqgan.parameters()]
    opt = pt.optim.adamw(pipe.trainable_parameters(), lr, (0.9, 0.96),
                         weight_decay=0.05, max_grad_norm=1.0)
    tstep = tsteps.make_pipeline_train_step(pipe, opt, grad_accum=grad_accum,
                                            ema_decay=0.9)
    for i in range(3):
        img = _images(20 + i, b)
        ctx = _context(30 + i, b) if i != 1 else None  # one CFG-dropped batch
        ratio = (0.55, 0.8, 0.3)[i]
        key_after, noise = _jax_step_noise(jstate['key'], grad_accum,
                                           b // grad_accum)
        jstate, jm = jstep(jstate, jnp.asarray(img),
                           None if ctx is None else jnp.asarray(ctx),
                           jnp.asarray(ratio, jnp.float32))
        assert np.array_equal(np.asarray(jstate['key']), np.asarray(key_after))
        tm = tstep(torch.from_numpy(img),
                   None if ctx is None else torch.from_numpy(ctx), ratio,
                   noise=torch.from_numpy(noise))
        assert abs(float(tm['loss']) - float(jm['loss'])) <= 1e-4, i
    assert tstep.state['step'] == 3 == int(jstate['step'])
    named = dict(pipe.named_parameters())
    for tree, tensors in ((jstate['params'], named),
                          (jstate['ema'], dict(zip(
                              [n for n, p in pipe.named_parameters()
                               if any(p is q for q in pipe.trainable_parameters())],
                              tstep.state['ema'])))):
        want = _grads_by_name(tree)
        for name, ref in want.items():
            diff = float(np.abs(_np(tensors[name]) - ref.numpy()).mean())
            assert diff <= 2e-5, (name, diff)
    assert all(torch.equal(a, b) for a, b in zip(vq0, pipe.vqgan.parameters()))


def test_one_lion_update_matches_jax(jparams):
    """Lion over one update (sign flips of near-zero entries make a longer
    comparison of weights ill-posed): with lr 1e-3 an entry whose sign
    differs lands 2e-3 away; at most 0.1 % of the entries do, and the rest
    agree to 1e-7."""
    b, lr = 4, 1e-3
    tx = jsteps.masked_tx(optax.lion(lr, b1=0.9, b2=0.99, weight_decay=0.05),
                          jparams)
    jstate = jsteps.init_pipeline_train_state(jax.random.PRNGKey(9), jparams, tx)
    jstep = jax.jit(jsteps.make_pipeline_train_step(J_PIPE, tx, backend='xla'))
    pipe = make_pipe(jparams)
    opt = pt.optim.lion(pipe.trainable_parameters(), lr, (0.9, 0.99),
                        weight_decay=0.05)
    tstep = tsteps.make_pipeline_train_step(pipe, opt)
    img, ctx = _images(40, b), _context(41, b)
    _, noise = _jax_step_noise(jstate['key'], 1, b)
    jstate, jm = jstep(jstate, jnp.asarray(img), jnp.asarray(ctx),
                       jnp.asarray(0.5, jnp.float32))
    tm = tstep(torch.from_numpy(img), torch.from_numpy(ctx), 0.5,
               noise=torch.from_numpy(noise))
    assert abs(float(tm['loss']) - float(jm['loss'])) <= 1e-5
    named = dict(pipe.named_parameters())
    flipped = total = 0
    for name, ref in _grads_by_name(jstate['params']).items():
        diff = np.abs(_np(named[name]) - ref.numpy())
        flipped += int((diff > 1e-4).sum())
        total += diff.size
        assert float(diff[diff <= 1e-4].max(initial=0.0)) <= 1e-7, name
    print(f'Lion, one update: {flipped} of {total} entries took another sign')
    assert flipped <= 1e-3 * total


def test_step_rejects_indivisible_batch_and_unported_options(jparams):
    pipe = make_pipe(jparams)
    opt = pt.optim.lion(pipe.trainable_parameters(), 1e-4)
    step = tsteps.make_pipeline_train_step(pipe, opt, grad_accum=2)
    with pytest.raises(ValueError, match='batch size 3 not divisible by '
                                         'grad_accum_steps=2'):
        step(torch.from_numpy(_images(0, 3)), None, 0.5)
    # a pipelined transformer_apply runs over a mesh (the working path is
    # held in tests/test_torch_pipeline_parallel.py)
    with pytest.raises(ValueError, match='needs mesh='):
        tsteps.make_pipeline_train_step(pipe, opt,
                                        transformer_apply=lambda *a: None)
    with pytest.raises(ValueError, match='ema_decay'):
        tsteps.make_pipeline_train_step(pipe, opt, state=step.state,
                                        ema_decay=0.9)
    half = make_pipe(jparams).bfloat16()
    with pytest.raises(ValueError, match='fp32 master weights'):
        tsteps.init_pipeline_train_state(
            half, pt.optim.lion(half.trainable_parameters(), 1e-4))


def test_pipeline_train_mode_keeps_vqgan_frozen(jparams):
    """``train()`` switches the transformer only; a built pipeline is frozen
    and in eval mode, and ``init_pipeline_train_state`` marks just the
    trainable half."""
    pipe = make_pipe(jparams)
    assert not pipe.training and not any(p.requires_grad
                                         for p in pipe.parameters())
    pipe.train()
    assert pipe.training and pipe.transformer.training
    assert not any(m.training for m in pipe.vqgan.modules())
    tsteps.init_pipeline_train_state(
        pipe, pt.optim.lion(pipe.trainable_parameters(), 1e-4))
    assert all(p.requires_grad for p in pipe.trainable_parameters())
    assert not any(p.requires_grad for p in pipe.vqgan.parameters())
    n_train = sum(p.numel() for p in pipe.trainable_parameters())
    n_vq = sum(p.numel() for p in pipe.vqgan.parameters())
    assert n_train + n_vq == pipe.num_params
    pipe.eval()
    assert not pipe.transformer.training


# ---------------------------------------------------------------------------
# trainer, checkpoints, data
# ---------------------------------------------------------------------------

class _SynthDataset:
    def __init__(self, n=32, size=32, with_caption=False):
        self.n, self.size, self.with_caption = n, size, with_caption

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        img = rng.uniform(-1, 1, (self.size, self.size, 3)).astype(np.float32)
        if self.with_caption:
            return img, f'caption {i}'
        return img


def _fake_embedder(captions):
    return np.stack([np.random.default_rng(len(c)).standard_normal(
        (5, 48)).astype(np.float32) for c in captions])


def _make_trainer(tmp_path, pipe, **kw):
    args = dict(num_epoch=2, valid_size=4, optim_name='lion', lr=1e-3,
                warmup_steps=1, decay_steps=10, batch_size=8, num_workers=2,
                grad_accum_steps=2, mixed_precision='no', save_every=100,
                sample_every=100, result_folder=str(tmp_path),
                log_dir=str(tmp_path / 'log'), text_embedder=_fake_embedder)
    args.update(kw)
    return pt.PaintMindTrainer(pipe, _SynthDataset(44, 32, with_caption=True),
                               **args)


def test_paintmind_trainer_end_to_end(tmp_path, jparams, monkeypatch):
    """The JAX package's own end-to-end test, on the port: 2 epochs x 2 host
    steps x 2 microbatches = 8 steps; the transformer trained, the VQGAN
    bit-equal; metrics logged as JSONL; the exported .npz and the state
    file written."""
    monkeypatch.setenv('PAINTMIND_JSONL_LOG', '1')
    pipe = make_pipe(jparams, dropout=0.1)
    trainer = _make_trainer(tmp_path, pipe)
    vq0 = [p.clone() for p in pipe.vqgan.parameters()]
    tr0 = [p.clone() for p in pipe.transformer.parameters()]
    trainer.train()
    assert trainer.steps == 8
    assert any(not torch.equal(a, b)
               for a, b in zip(tr0, pipe.transformer.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(vq0, pipe.vqgan.parameters()))
    assert np.isfinite(trainer.log['loss'])
    assert abs(trainer.log['lr'] - trainer.scheduler(8)) < 1e-12
    lines = open(tmp_path / 'log' / 'paintmind' / 'metrics.jsonl').readlines()
    assert len(lines) == 4
    saved = sorted(os.listdir(tmp_path / 'models'))
    assert saved == ['paintmind_state_8.pt', 'paintmind_step_8.npz']
    assert not pipe.training


def test_trainer_save_resume_same_next_loss(tmp_path, jparams):
    """save -> resume('auto') into a second trainer -> its next step on the
    same batch gives the first trainer's next loss bit for bit (model,
    optimizer, step and every generator restored), with dropout, CFG text
    dropout and EMA on; ``keep_last`` prunes older generations;
    ``evaluate()`` writes its grid."""
    def build(folder):
        return _make_trainer(folder, make_pipe(jparams, dropout=0.1),
                             ema_decay=0.9, keep_last=2, cfg_p=0.5,
                             optim_name='adamw', valid_size=6)
    folder = tmp_path / 'a'
    first = build(folder)
    batches = [b for b in first.train_dl][:2]
    for _ in range(3):
        first.train_step(batches[0])
        first.save()
    assert first.steps == 6
    assert sorted(os.listdir(folder / 'models')) == [
        'paintmind_state_4.pt', 'paintmind_state_6.pt',
        'paintmind_step_4.npz', 'paintmind_step_6.npz']
    want = [float(first.train_step(b)['loss']) for b in batches]

    second = build(folder).resume('auto')
    assert second.steps == 6 and second.state['step'] == 3
    got = [float(second.train_step(b)['loss']) for b in batches]
    assert got == want
    for a, b in zip(first.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(first.state['ema'], second.state['ema']):
        assert torch.equal(a, b)

    raw = [p.clone() for p in second.model.trainable_parameters()]
    second.log = ttrainer.Log()
    second.evaluate()
    assert os.path.exists(folder / 'images' / f'step_{second.steps}_0.png')
    # the JAX package's _sync_model: after evaluate() the model holds the
    # averages, and the raw weights wait for the next training step
    assert all(torch.equal(a, e) for a, e in
               zip(second.model.trainable_parameters(), second.state['ema']))
    assert all(torch.equal(a, b) for a, b in zip(raw, second._raw))
    with pytest.raises(FileNotFoundError, match='auto-resume'):
        _make_trainer(tmp_path / 'empty', make_pipe(jparams)).resume('auto')


def test_trainer_preemption_saves_and_resumes(tmp_path, jparams):
    """A real SIGTERM in mid-run: the trainer finishes the step, saves a
    complete generation and leaves ``train()``; ``resume('auto')`` in a new
    trainer restores it bit for bit and training goes on; the previous
    signal handler is back in place."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    trainer = _make_trainer(tmp_path, make_pipe(jparams), grad_accum_steps=1,
                            num_epoch=3)
    step, calls = trainer._step, []

    def step_then_sigterm(*a):
        calls.append(1)
        out = step(*a)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer._step = step_then_sigterm
    trainer.train()
    assert trainer._preempted and trainer.steps == 2
    assert signal.getsignal(signal.SIGTERM) is before
    assert 'paintmind_state_2.pt' in os.listdir(tmp_path / 'models')
    second = _make_trainer(tmp_path, make_pipe(jparams), grad_accum_steps=1,
                           num_epoch=3).resume('auto')
    assert second.steps == 2
    for a, b in zip(trainer.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    second.train()
    assert second.steps == 2 + 3 * 5 and not second._preempted


@pytest.mark.parametrize('kwarg,error,match', [
    ({'mesh': object()}, TypeError, 'parallel.mesh.Mesh'),
    ({'zero_sharding': True}, ValueError, 'zero_sharding needs mesh='),
    ({'pp_microbatches': 2}, ValueError, 'pp_microbatches needs mesh=')])
def test_trainer_multi_gpu_options_raise(tmp_path, jparams, kwarg, error,
                                         match):
    """The multi-GPU options are ported (tests/test_torch_multiprocess.py,
    test_torch_pipeline_parallel.py); without a mesh (or with another
    object) they are refused."""
    with pytest.raises(error, match=match):
        _make_trainer(tmp_path, make_pipe(jparams), **kwarg)


def test_trainer_non_finite_loss_raises(tmp_path, jparams):
    pipe = make_pipe(jparams)
    trainer = _make_trainer(tmp_path, pipe)
    with torch.no_grad():
        pipe.transformer.to_logits.bias.fill_(float('nan'))
    with pytest.raises(FloatingPointError, match='non-finite loss at step 2'):
        trainer.train()


def test_reverse_bridge_loads_in_jax_package(tmp_path, jparams):
    """A model trained by the port, saved with ``save_pretrained``, loads in
    ``paintmind_tpu``'s ``Pipeline.from_pretrained`` with the same logits
    (1e-5), and back into the port bit-equal; a bf16 leaf keeps its bits
    through the ``::bf16`` tag."""
    pipe = make_pipe(jparams)
    opt = pt.optim.adamw(pipe.trainable_parameters(), 1e-3)
    step = tsteps.make_pipeline_train_step(pipe, opt)
    step(torch.from_numpy(_images(50, 4)), torch.from_numpy(_context(51, 4)), 0.5)
    pipe.eval()
    path = pipe.save_pretrained(str(tmp_path / 'trained.npz'))
    flat = to_flat(pipe)
    assert set(flat) == set(flatten_tree(jparams))
    for k, v in flatten_tree(jparams).items():
        assert flat[k].shape == v.shape, k

    jpipe = jpl.Pipeline(J_PIPE, stage1_pretrained=False, text_encoder=None)
    jpipe.from_pretrained(path)
    tokens = np.random.default_rng(52).standard_normal((2, L, 8)).astype(np.float32)
    ctx = _context(53, 2)
    with torch.no_grad():
        got = pipe.tokens2logits(tokens, ctx)
    ref = jpipe.tokens2logits(tokens, jnp.asarray(ctx))
    assert float(np.abs(_np(got) - np.asarray(ref)).max()) <= 1e-5
    assert not np.allclose(np.asarray(ref), np.asarray(jpl.cond_transformer_apply(
        jparams['transformer'], jnp.asarray(tokens), jnp.asarray(ctx),
        cfg=J_PIPE.tcfg)))  # the trained weights, not the init

    back = make_pipe(jparams).from_pretrained(path)
    for (n, a), (_, b) in zip(pipe.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n

    half = make_pipe(jparams).bfloat16()
    flat16 = to_flat(half)
    assert all(k.endswith('::bf16') and v.dtype == np.uint16
               for k, v in flat16.items())
    p16 = half.save_pretrained(str(tmp_path / 'half.npz'))
    again = make_pipe(jparams).bfloat16().from_pretrained(p16)
    for a, b in zip(half.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_dataloader_errors_early_break_and_split():
    """A dataset error surfaces in the consumer (no hang); breaking out of
    an epoch early leaves no stuck producer; the split and the shuffle are
    those of the JAX package's loader."""
    from paintmind_tpu.utils import data as jdata

    class Bad(_SynthDataset):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError('item 5 is broken')
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match='DataLoader worker failed') as err:
        list(tdata.DataLoader(Bad(16), 4, shuffle=False, num_workers=2))
    assert isinstance(err.value.__cause__, KeyError)

    dl = tdata.DataLoader(_SynthDataset(64), 4, num_workers=2, prefetch=1)
    for n, _ in enumerate(dl):
        if n == 1:
            break
    assert len(list(dl)) == 16  # a fresh epoch still runs to its end

    ds = _SynthDataset(20, with_caption=True)
    ta, tb = tdata.random_split(ds, [15, 5], seed=42)
    ja, jb = jdata.random_split(ds, [15, 5], seed=42)
    np.testing.assert_array_equal(ta.indices, ja.indices)
    np.testing.assert_array_equal(tb.indices, jb.indices)
    with pytest.raises(ValueError, match='do not sum'):
        tdata.random_split(ds, [15, 4])
    tbatches = list(tdata.DataLoader(ta, 5, seed=3, num_workers=1))
    jbatches = list(jdata.DataLoader(ja, 5, seed=3, num_workers=1))
    assert len(tbatches) == 3
    for (ti, tc), (ji, jc) in zip(tbatches, jbatches):
        np.testing.assert_array_equal(ti, ji)
        assert tc == jc and ti.dtype == np.float32
