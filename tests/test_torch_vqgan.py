"""The port's stage-1 training path held against the JAX package on the CPU.

Small configuration: 32² images, patch 8, 2 + 2 layers of dim 32 with 2
heads of 16, an 8-dim codebook of 64 codes, the discriminator at ndf 8 (three
stride-2 layers).  Inputs come from numpy seeds; parameters are JAX inits
carried over by the weight bridge; the random numbers the JAX step draws
from its key (the gradient penalty's mixes, the codebook restart's picks,
the masking noise of stage 2) are handed to the port.  Everything runs in
fp32.  Tolerances are stated in each test.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
import paintmind_tpu.utils.trainer as jtrainer
from paintmind_tpu import optim as joptim
from paintmind_tpu.models import discriminator as jdisc
from paintmind_tpu.models import lpips as jlpips
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.models import quantize as jquant
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.train import steps as jsteps
from paintmind_tpu.utils import metrics as jmetrics
from paintmind_tpu.utils.checkpoint import flatten_tree
from paintmind_tpu.utils.checkpoint import save_params as jsave_params
import paintmind_tpu_torch as pt
import paintmind_tpu_torch.utils.trainer as ttrainer
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.convert.from_jax import (
    load_discriminator_params, load_jax_params, load_lpips_params,
    to_state_dict)
from paintmind_tpu_torch.models import discriminator as tdisc
from paintmind_tpu_torch.models import lpips as tlpips
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import quantize as tquant
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.train import steps as tsteps
from paintmind_tpu_torch.utils import metrics as tmetrics

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
jcfg.register_version('torch-port-vqgan-stage1', SMALL_VQ)
tcfg.register_version('torch-port-vqgan-stage1', SMALL_VQ)
tcfg.register_version('torch-port-vqgan-stage1-pipe', {
    'stage1': 'torch-port-vqgan-stage1', 't5': 't5-l', 'dim': 32,
    'dim_head': 16, 'mlp_dim': 64, 'num_head': 2, 'depth': 2, 'dropout': 0.0})
J_CFG = jvm.VQModelConfig.from_dict(SMALL_VQ)
J_DCFG = jdisc.DiscriminatorConfig(input_nc=3, ndf=8, n_layers=3)
T_DCFG = tdisc.DiscriminatorConfig(input_nc=3, ndf=8, n_layers=3)
L = J_CFG.enc.num_patches


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _images(seed, b, size=32):
    """Smooth seeded images in [-1, 1]: a 4x4 grid upsampled, plus noise."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(-0.8, 0.8, (b, 4, 4, 3))
    img = np.kron(low, np.ones((1, size // 4, size // 4, 1)))
    return np.clip(img + rng.normal(0, 0.05, img.shape), -1, 1).astype(np.float32)


@pytest.fixture(scope='module')
def jvq():
    return _jax_init_vq(jax.random.PRNGKey(0))


# the JAX inits, jitted: op by op they dispatch and compile each random draw
_jax_init_vq = jax.jit(functools.partial(jvm.init_vqmodel, cfg=J_CFG))
_jax_init_disc = jax.jit(functools.partial(jdisc.init_discriminator,
                                           cfg=J_DCFG))
_jax_init_lpips = jax.jit(jlpips.init_lpips)


def make_vq(jparams):
    return load_jax_params(tvm.VQModel(SMALL_VQ, device='cpu'),
                           flatten_tree(jparams))


def make_disc(params, stats):
    return load_discriminator_params(tdisc.Discriminator(T_DCFG, device='cpu'),
                                     params, stats)


def _grads_as_module(module):
    """A copy of ``module`` whose parameters are its gradients (zero where
    autograd reached none, as ``jax.grad`` gives zeros), for the bridges."""
    out = copy.deepcopy(module)
    for p, q in zip(out.parameters(), module.parameters()):
        p.data.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return out


@torch.no_grad()
def discriminator_to_flat(module):
    """A port discriminator as (flat ``params``, flat ``stats``) in the JAX
    package's keys, numpy arrays: what the tests compare."""
    params, stats = {}, {}
    for name, v in module.state_dict().items():
        _, i, mod, leaf = name.split('.')
        v = v.detach().cpu()
        if mod == 'conv':
            if leaf == 'weight':
                params[f'{i}/conv/kernel'] = v.permute(2, 3, 1, 0).numpy()
            else:
                params[f'{i}/conv/bias'] = v.numpy()
        elif leaf.startswith('running_'):
            stats[f'{i}/bn/{leaf[len("running_"):]}'] = v.numpy()
        else:
            params[f'{i}/bn/' + ('scale' if leaf == 'weight' else 'bias')] = \
                v.numpy()
    return params, stats


def _disc_flat(params, stats):
    """JAX discriminator trees -> flat numpy dicts, the keys of
    ``discriminator_to_flat``."""
    return ({k: np.asarray(v) for k, v in flatten_tree(params).items()},
            {k: np.asarray(v) for k, v in flatten_tree(stats).items()})


# ---------------------------------------------------------------------------
# C1: the commitment loss's gradient
# ---------------------------------------------------------------------------

def test_commitment_loss_gradient_matches_jax():
    """The quantiser's loss ``β·mean((sg(q) − z)²) + mean((q − sg(z))²)``:
    its value and its gradients with respect to the pre-norm z and the
    codebook equal ``jax.grad`` of ``paintmind_tpu.models.quantize.quantize``
    within 1e-6 max abs (fp32); so does the gradient that reaches z through
    the straight-through output.  (The loss the port had before, (1 + β) ·
    mse with no stop-gradient, sends the encoder 5x this gradient.)"""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 16, 8)).astype(np.float32)
    cb = rng.standard_normal((64, 8)).astype(np.float32)
    w = rng.standard_normal((2, 16, 8)).astype(np.float32)

    def jloss(z_, cb_):
        return jquant.quantize({'codebook': cb_}, z_, 0.25, backend='xla')[1]

    def jout(z_, cb_):
        return jnp.sum(jquant.quantize({'codebook': cb_}, z_, 0.25,
                                       backend='xla')[0] * w)

    jl, (jgz, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(z), jnp.asarray(cb))
    jl = float(jl)
    jsz = jax.jit(jax.grad(jout))(jnp.asarray(z), jnp.asarray(cb))

    q = tquant.Quantizer(64, 8)
    with torch.no_grad():
        q.codebook.copy_(torch.from_numpy(cb))
    tz = torch.from_numpy(z).requires_grad_(True)
    z_q, loss, ids = q(tz, 0.25)
    gz, gc = torch.autograd.grad(loss, (tz, q.codebook), retain_graph=True)
    (sz,) = torch.autograd.grad((z_q * torch.from_numpy(w)).sum(), tz)
    assert abs(float(loss) - jl) <= 1e-6
    for got, want in ((gz, jgz), (gc, jgc), (sz, jsz)):
        assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 1e-6
    print(f'C1: loss {float(loss):.6f}, |dz| max err '
          f'{np.abs(_np(gz) - np.asarray(jgz)).max():.2e}, |dcodebook| max '
          f'err {np.abs(_np(gc) - np.asarray(jgc)).max():.2e}')


# ---------------------------------------------------------------------------
# Discriminator, losses, LPIPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('train', [True, False])
def test_discriminator_forward_and_batch_stats_match_jax(train):
    """Patch logits within 1e-5 max abs of ``discriminator_apply``; in
    training mode the BatchNorm running statistics move as JAX's do
    (momentum 0.1, unbiased variance) within 1e-6, twice in a row; in eval
    mode they stay."""
    params, stats = _jax_init_disc(jax.random.PRNGKey(1))
    d = make_disc(params, stats)
    apply = jax.jit(functools.partial(jdisc.discriminator_apply, train=train,
                                      cfg=J_DCFG))
    for i in range(2):
        x = _images(10 + i, 2)
        jout, stats = apply(params, stats, jnp.asarray(x))
        out = d(torch.from_numpy(x), train=train)
        assert out.shape == jout.shape == (2, 2, 2, 1)
        assert float(np.abs(_np(out) - np.asarray(jout)).max()) <= 1e-5
        _, tstats = discriminator_to_flat(d)
        for k, v in _disc_flat(params, stats)[1].items():
            assert float(np.abs(tstats[k] - v).max()) <= 1e-6, k


def test_convert_discriminator_matches_jax():
    """A reference NLayerDiscriminator ``state_dict`` (seeded, torch
    Sequential names) through the port's ``convert_discriminator`` gives
    the module that the JAX package's converter plus the weight bridge
    give: every parameter and statistic equal."""
    rng = np.random.default_rng(4)
    t = T_DCFG
    widths = [t.ndf * min(2 ** n, 8) for n in range(t.n_layers + 1)]
    sd, idx, cin = {}, 0, t.input_nc
    for i, cout in enumerate(widths + [1]):
        sd[f'model.{idx}.weight'] = rng.standard_normal(
            (cout, cin, 4, 4)).astype(np.float32)
        if i in (0, t.n_layers + 1):
            sd[f'model.{idx}.bias'] = rng.standard_normal(cout).astype(np.float32)
            idx += 2
        else:
            for name in ('weight', 'bias', 'running_mean'):
                sd[f'model.{idx + 1}.{name}'] = rng.standard_normal(
                    cout).astype(np.float32)
            sd[f'model.{idx + 1}.running_var'] = rng.uniform(
                0.5, 2, cout).astype(np.float32)
            idx += 3
        cin = cout
    want = make_disc(*jdisc.convert_discriminator(sd, J_DCFG))
    got = tdisc.Discriminator(T_DCFG, device='cpu')
    got.load_state_dict(tdisc.convert_discriminator(sd, T_DCFG))
    for (name, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), name


def test_losses_and_gradient_penalty_match_jax():
    """``hinge_d_loss`` and ``g_nonsaturating_loss`` within 1e-6; the
    gradient penalty on JAX's own ``eta`` (drawn from its key and handed
    over): the penalty within 1e-5 relative, the statistics it moves within
    1e-6, and its gradient with respect to D's parameters (a double
    backward) within 1e-4 relative per leaf."""
    rng = np.random.default_rng(3)
    fake, real = (rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
                  for _ in range(2))
    assert abs(float(tdisc.hinge_d_loss(torch.from_numpy(fake),
                                        torch.from_numpy(real)))
               - float(jdisc.hinge_d_loss(fake, real))) <= 1e-6
    assert abs(float(tdisc.g_nonsaturating_loss(torch.from_numpy(fake)))
               - float(jdisc.g_nonsaturating_loss(fake))) <= 1e-6

    params, stats = _jax_init_disc(jax.random.PRNGKey(2))
    real, rec = _images(20, 2), _images(21, 2)
    key = jax.random.PRNGKey(5)
    eta = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))

    def jgp(p):
        return jdisc.gradient_penalty(p, stats, jnp.asarray(real),
                                      jnp.asarray(rec), key, cfg=J_DCFG)

    (jpen, jstats), jgrads = jax.jit(jax.value_and_grad(jgp, has_aux=True))(
        params)
    d = make_disc(params, stats)
    pen = tdisc.gradient_penalty(d, torch.from_numpy(real),
                                 torch.from_numpy(rec), torch.from_numpy(eta))
    pen.backward()
    assert _rel(float(pen), float(jpen)) <= 1e-5
    _, tstats = discriminator_to_flat(d)
    for k, v in _disc_flat(params, jstats)[1].items():
        assert float(np.abs(tstats[k] - v).max()) <= 1e-6, k
    gmod = _grads_as_module(d)
    tgrads, _ = discriminator_to_flat(gmod)
    for k, v in _disc_flat(jgrads, jstats)[0].items():
        assert _rel(tgrads[k], v) <= 1e-4, k


def test_lpips_matches_jax_on_a_random_tree(tmp_path):
    """``lpips`` on a seeded random JAX tree carried across (nested, and
    through the JAX package's ``.npz`` and ``load_lpips``): distances within
    1e-5 relative, and their gradient with respect to x within 1e-4
    relative."""
    tree = _jax_init_lpips(jax.random.PRNGKey(3))
    x, y = _images(30, 2), _images(31, 2)
    jd, jvjp = jax.vjp(lambda a: jax.jit(jlpips.lpips)(tree, a, jnp.asarray(y)),
                       jnp.asarray(x))
    (jg,) = jvjp(jnp.ones_like(jd))
    model = load_lpips_params(tlpips.LPIPS(device='cpu'), tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    d = model(tx, torch.from_numpy(y))
    (g,) = torch.autograd.grad(d.sum(), tx)
    assert d.shape == (2,)
    assert _rel(_np(d), np.asarray(jd)) <= 1e-5
    assert _rel(_np(g), np.asarray(jg)) <= 1e-4
    path = jsave_params(str(tmp_path / 'lpips_vgg.npz'), tree)
    loaded = tlpips.load_lpips(path, device='cpu')
    assert torch.equal(loaded(torch.from_numpy(x), torch.from_numpy(y)), d.detach())


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _tx(lr=1e-3, clip=1.0):
    """The same Adam (0.9, 0.99) with clipping on both sides."""
    return (joptim.adam(lr, (0.9, 0.99), clip),
            lambda ps: pt.optim.adam(ps, lr, (0.9, 0.99), clip))


def _jax_draws(key, grad_accum, micro):
    """The gradient-penalty mixes and the codebook restart's picks that one
    JAX step draws from the state's key."""
    key, k_step = jax.random.split(key)
    gp_keys = jax.random.split(k_step, grad_accum)
    eta = np.concatenate([np.asarray(jax.random.uniform(k, (micro, 1, 1, 1)))
                          for k in gp_keys])
    _, k_restart = jax.random.split(key)
    picks = np.asarray(jax.random.randint(k_restart, (J_CFG.n_embed,), 0,
                                          micro * L))
    return eta, picks


def _pair(jvq, *, grad_accum=1, ema=None, restart=None, share_forward=True):
    """A JAX step and a port step over the same weights (no LPIPS)."""
    jtx, ttx = _tx()
    jstate = jsteps.init_vqgan_train_state(
        jax.random.PRNGKey(1), jvq, jtx, jtx, J_DCFG, ema_decay=ema,
        codebook_restart_every=restart)
    jstep = jax.jit(jsteps.make_vqgan_train_step(
        J_CFG, jtx, jtx, dcfg=J_DCFG, grad_accum=grad_accum,
        backend='xla', ema_decay=ema,
        codebook_restart_every=restart, share_forward=share_forward))
    vq = make_vq(jvq)
    tstep = tsteps.make_vqgan_train_step(
        vq, ttx, ttx, dcfg=T_DCFG, grad_accum=grad_accum, ema_decay=ema, codebook_restart_every=restart,
        share_forward=share_forward)
    load_discriminator_params(tstep.state['d'], jstate['d_params'],
                              jstate['d_stats'])
    return jstate, jstep, vq, tstep


# Metric gates: the first update within 1e-5 relative (measured <= 2e-6);
# the second within 1e-3, because Adam's first update moves every weight by
# about +-lr whatever the size of its gradient, so the weights whose
# gradient is near Adam's eps (1e-8) carry the two packages' rounding into
# the second update at up to 2e-5 (measured, lr 1e-3), and a GAN's losses
# feel the discriminator's weights one to one (measured 5.5e-5 in 'g loss').
METRIC_GATES = (1e-5, 1e-3)


def _check_metrics(jms, tms):
    for gate, jm, tm in zip(METRIC_GATES, jms, tms):
        assert jm.keys() == tm.keys()
        for k in jm:
            assert _rel(tm[k], jm[k]) <= gate, (k, tm[k], jm[k], gate)


def _run(jstate, jstep, tstep, steps, b, grad_accum):
    jms, tms = [], []
    for i in range(steps):
        img = _images(40 + i, b)
        eta, picks = _jax_draws(jstate['key'], grad_accum, b // grad_accum)
        jstate, jm = jstep(jstate, jnp.asarray(img))
        jms.append({k: float(v) for k, v in jm.items()})
        tm = tstep(torch.from_numpy(img), eta=torch.from_numpy(eta),
                   picks=torch.from_numpy(picks))
        tms.append({k: float(v) for k, v in tm.items()})
    return jstate, jms, tms


def _check_state(jstate, vq, tstep, ema=False, tol=2e-5):
    """Weights, D's parameters and statistics (and EMA) within ``tol`` mean
    abs of the JAX state."""
    own = to_state_dict(flatten_tree(jstate['g_params']))
    for name, p in vq.named_parameters():
        assert float(np.abs(_np(p) - own[name].numpy()).mean()) <= tol, name
    tparams, tstats = discriminator_to_flat(tstep.state['d'])
    jparams, jstats = _disc_flat(jstate['d_params'], jstate['d_stats'])
    for t, j in ((tparams, jparams), (tstats, jstats)):
        assert t.keys() == j.keys()
        for k in j:
            assert float(np.abs(t[k] - j[k]).mean()) <= tol, k
    if ema:
        want = to_state_dict(flatten_tree(jstate['g_ema']))
        for (name, _), e in zip(vq.named_parameters(), tstep.state['g_ema']):
            assert float(np.abs(_np(e) - want[name].numpy()).mean()) <= tol, name


@pytest.mark.parametrize('share_forward', [True, False])
def test_two_updates_match_jax(jvq, share_forward):
    """Two updates of ``make_vqgan_train_step`` (B = 4, Adam with clipping;
    LPIPS is held in ``test_gradients_match_jax``) against the JAX step
    in the same form on the same images and the same gradient-penalty
    mixes: the metrics within ``METRIC_GATES``; after two updates, the
    VQGAN's weights, the discriminator's parameters and its BatchNorm
    statistics within 2e-5 mean abs (Adam's normalised update amplifies
    rounding where the second moment is tiny)."""
    jstate, jstep, vq, tstep = _pair(jvq, share_forward=share_forward)
    jstate, jms, tms = _run(jstate, jstep, tstep, 2, 4, 1)
    _check_metrics(jms, tms)
    assert tstep.state['step'] == 2 == int(jstate['step'])
    _check_state(jstate, vq, tstep)
    print(f'share_forward={share_forward}: ' + ', '.join(
        f'{k} {tms[-1][k]:.6f}' for k in tms[-1]))


def test_share_forward_equals_two_pass(jvq):
    """The port's one-forward and two-forward steps (no LPIPS) give the
    same metrics and weights within 1e-6: only where the D phase's
    reconstruction is computed differs."""
    runs = []
    for share in (True, False):
        jstate, jstep, vq, tstep = _pair(jvq, share_forward=share)
        img = torch.from_numpy(_images(50, 4))
        eta = torch.linspace(0.1, 0.9, 4).reshape(4, 1, 1, 1)
        m = tstep(img, eta=eta)
        runs.append((m, [p.detach().clone() for p in vq.parameters()],
                     [p.detach().clone() for p in tstep.state['d'].parameters()]))
    (ma, ga, da), (mb, gb, db) = runs
    for k in ma:
        assert abs(float(ma[k]) - float(mb[k])) <= 1e-6, k
    for a, b in zip(ga + da, gb + db):
        assert float((a - b).abs().max()) <= 1e-6


def test_gradients_match_jax(jvq):
    """One microbatch's D-phase and G-phase gradients (the step's helpers
    ``vqgan_d_loss`` / ``vqgan_g_loss`` with ``backward()``) against
    ``jax.grad`` of the same terms composed from the JAX package's
    functions, with LPIPS: within 1e-4 relative per leaf; the G backward
    leaves no gradient in D's parameters."""
    params, stats = _jax_init_disc(jax.random.PRNGKey(1))
    tree = _jax_init_lpips(jax.random.PRNGKey(7))
    img = _images(60, 4)
    eta = np.linspace(0.2, 0.8, 4, dtype=np.float32).reshape(4, 1, 1, 1)

    def jfwd(gp_):
        z, cb, _ = jvm.encode(gp_, jnp.asarray(img), J_CFG, backend='xla',
                              vq_backend='xla')
        return jvm.decode(gp_, z, J_CFG, backend='xla'), cb

    rec, _ = jax.jit(jfwd)(jvq)

    def jd_loss(dp):
        fake, st = jdisc.discriminator_apply(dp, stats, rec, True, J_DCFG)
        real, st = jdisc.discriminator_apply(dp, st, jnp.asarray(img), True, J_DCFG)
        interp = eta * jnp.asarray(img) + (1 - eta) * rec

        def d_sum(x):
            out, s = jdisc.discriminator_apply(dp, st, x, True, J_DCFG)
            return jnp.sum(out), s

        g, st = jax.grad(d_sum, has_aux=True)(interp)
        norm = jnp.sqrt(jnp.sum(jnp.square(g), axis=-1) + 1e-12)
        gp = jnp.mean(jnp.square(norm - 1.0)) * 10.0
        return jdisc.hinge_d_loss(fake, real) + gp, st

    (jdl, jst), jdg = jax.jit(jax.value_and_grad(jd_loss, has_aux=True))(params)

    def jg_loss(gp_):
        r, cb = jfwd(gp_)
        rl = jnp.mean(jnp.abs(r - img)) + jnp.mean(jnp.square(r - img))
        pl_ = jnp.mean(jlpips.lpips(tree, r, jnp.asarray(img)))
        fake, _ = jdisc.discriminator_apply(params, jst, r, True, J_DCFG)
        return cb + rl + pl_ + 0.1 * jdisc.g_nonsaturating_loss(fake)

    jgl, jgg = jax.jit(jax.value_and_grad(jg_loss))(jvq)

    vq = make_vq(jvq)
    d = make_disc(params, stats)
    timg = torch.from_numpy(img)
    z, cb, _ = tvm.encode(vq, timg)
    trec = tvm.decode(vq, z)
    dl = tsteps.vqgan_d_loss(d, timg, trec.detach(), torch.from_numpy(eta))
    dl.backward()
    assert _rel(float(dl), float(jdl)) <= 1e-5
    gmod = _grads_as_module(d)
    for k, v in _disc_flat(jdg, jst)[0].items():
        assert _rel(discriminator_to_flat(gmod)[0][k], v) <= 1e-4, k
    d.zero_grad(set_to_none=True)
    d.requires_grad_(False)
    lp = load_lpips_params(tlpips.LPIPS(device='cpu'), tree)
    gl, _ = tsteps.vqgan_g_loss(trec, cb, d, timg, lp)
    gl.backward()
    assert all(p.grad is None for p in d.parameters())
    assert _rel(float(gl), float(jgl)) <= 1e-5
    want = to_state_dict(flatten_tree(jgg))
    for name, p in vq.named_parameters():
        assert _rel(_np(p.grad), want[name].numpy()) <= 1e-4, name


def test_grad_accum_ema_and_codebook_restart_match_jax(jvq):
    """``grad_accum=2`` (B = 8), EMA 0.9 and a codebook restart at every
    update, on the JAX step's own restart picks: metrics within
    ``METRIC_GATES``, 'restarted codes' equal; after two updates weights,
    D, statistics and EMA within 2e-5 mean abs."""
    jstate, jstep, vq, tstep = _pair(jvq, grad_accum=2, ema=0.9, restart=1)
    jstate, jms, tms = _run(jstate, jstep, tstep, 2, 8, 2)
    _check_metrics(jms, tms)
    for jm, tm in zip(jms, tms):
        assert tm['restarted codes'] == jm['restarted codes'] > 0
    _check_state(jstate, vq, tstep, ema=True)
    assert int(tstep.state['code_usage'].sum()) == 0


def test_step_rejects_mismatched_options(jvq):
    vq = make_vq(jvq)
    _, ttx = _tx()
    state = tsteps.init_vqgan_train_state(vq, ttx, ttx, T_DCFG)
    with pytest.raises(ValueError, match='ema_decay'):
        tsteps.make_vqgan_train_step(vq, ttx, ttx, dcfg=T_DCFG, state=state,
                                     ema_decay=0.9)
    step = tsteps.make_vqgan_train_step(vq, ttx, ttx, dcfg=T_DCFG, state=state,
                                        grad_accum=2)
    with pytest.raises(ValueError, match='not divisible'):
        step(torch.zeros(3, 32, 32, 3))


# ---------------------------------------------------------------------------
# VQGANTrainer
# ---------------------------------------------------------------------------

class _SynthDataset:
    def __init__(self, n, size=32):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return _images(1000 + i, 1, self.size)[0]


def _vq_trainer(tmp_path, vq, **kw):
    args = dict(num_epoch=1, valid_size=8, lr=1e-3, warmup_steps=1,
                batch_size=8, num_workers=1, mixed_precision='no',
                save_every=100, sample_every=100, result_folder=str(tmp_path),
                log_dir=str(tmp_path / 'log'), perceptual_weights='none',
                disc_config=T_DCFG, seed=3)
    args.update(kw)
    return pt.VQGANTrainer(vq, _SynthDataset(40), **args)


def test_vqgan_trainer_end_to_end(tmp_path, jvq, monkeypatch):
    """``train()`` (4 updates, EMA, a codebook restart every 2) saves, and
    the model then holds the averages (the JAX package's ``_sync_model``);
    ``resume('auto')`` into a trainer over another VQGAN restores them, and
    both trainers' next update on one batch is bit-equal; ``evaluate()``
    logs PSNR and codebook usage and perplexity that equal the JAX
    package's metrics on the same weights (JAX's ``VQModel`` loading the
    port's ``save_pretrained`` export): PSNR within 1e-3 dB, usage equal,
    perplexity within 1e-4 relative."""
    monkeypatch.setenv('PAINTMIND_JSONL_LOG', '1')
    vq = make_vq(jvq)
    first = _vq_trainer(tmp_path, vq, ema_decay=0.9, codebook_restart_every=2)
    first.train()
    assert first.steps == 4 and np.isfinite(first.log['loss'])
    assert sorted(os.listdir(tmp_path / 'models')) == [
        'vit_vq_state_4.pt', 'vit_vq_step_4.npz']
    for p, e in zip(vq.parameters(), first.state['g_ema']):
        assert torch.equal(p, e)

    second = _vq_trainer(tmp_path, make_vq(_jax_init_vq(
        jax.random.PRNGKey(9))), ema_decay=0.9,
        codebook_restart_every=2).resume('auto')
    assert second.steps == 4 and second.state['step'] == 4
    for a, b in zip(vq.parameters(), second.vqvae.parameters()):
        assert torch.equal(a, b)
    batch = next(iter(first.train_dl))
    want = {k: float(v) for k, v in first.train_step(batch).items()}
    got = {k: float(v) for k, v in second.train_step(batch).items()}
    assert got == want

    first.evaluate()
    export = str(tmp_path / 'eval.npz')
    vq.save_pretrained(export)
    jmodel = jvm.VQModel(SMALL_VQ, seed=0).from_pretrained(export)
    ids, psnrs = [], []
    for batch in first.valid_dl:
        imgs = np.asarray(batch[0], np.float32)  # (images, None)
        z, _, i = jmodel.encode(imgs)
        rec = np.asarray(jmodel.decode(z), np.float32)
        ids.append(np.asarray(i))
        psnrs.append(jmetrics.psnr(rec, imgs))
    stats = jmetrics.codebook_stats(np.concatenate(ids), J_CFG.n_embed)
    assert abs(first.log['val psnr'] - float(np.mean(psnrs))) <= 1e-3
    assert first.log['codebook usage'] == stats['usage']
    assert _rel(first.log['codebook perplexity'], stats['perplexity']) <= 1e-4
    assert os.path.exists(tmp_path / 'images' / f'step_{first.steps}_0.png')
    print(f"VQGANTrainer evaluate: psnr {first.log['val psnr']:.4f} (JAX "
          f"{np.mean(psnrs):.4f}), usage {first.log['codebook usage']}, "
          f"perplexity {first.log['codebook perplexity']:.4f} (JAX "
          f"{stats['perplexity']:.4f})")


def test_vqgan_trainer_evaluate_changes_no_later_weight(tmp_path, jvq):
    """An ``evaluate()`` between two updates leaves the later weights and
    averages as they are without it, bit for bit."""
    runs = []
    for with_eval in (False, True):
        trainer = _vq_trainer(tmp_path / str(with_eval), make_vq(jvq),
                              ema_decay=0.9)
        batches = [b for b in trainer.train_dl][:2]
        trainer.train_step(batches[0])
        if with_eval:
            trainer.evaluate()
        trainer.train_step(batches[1])
        runs.append([p.detach().clone() for p in trainer.vqvae.parameters()]
                    + [e.clone() for e in trainer.state['g_ema']])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_lpips_auto_fails_loudly_without_weights(tmp_path, jvq):
    """As the JAX package's test: 'auto' without the converted LPIPS
    weights raises, naming ``perceptual_weights``; 'random' and 'none'
    construct."""
    assets = os.path.join(os.path.dirname(ttrainer.__file__), '..', 'assets',
                          'lpips_vgg.npz')
    if os.path.exists(assets):
        pytest.skip('converted LPIPS weights present; auto path is parity')
    with pytest.raises(FileNotFoundError, match='perceptual_weights'):
        _vq_trainer(tmp_path, make_vq(jvq), perceptual_weights='auto')
    t = _vq_trainer(tmp_path, make_vq(jvq), perceptual_weights='random')
    assert isinstance(t.lpips, tlpips.LPIPS)
    assert _vq_trainer(tmp_path, make_vq(jvq)).lpips is None


@pytest.mark.parametrize('kwarg,error,match', [
    ({'mesh': object()}, TypeError, 'parallel.mesh.Mesh'),
    ({'zero_sharding': True}, ValueError, 'zero_sharding needs mesh=')])
def test_vqgan_trainer_unported_options_raise(tmp_path, jvq, kwarg, error,
                                              match):
    """The multi-GPU options are ported (the sync-BN step is held in
    tests/test_torch_parallel.py); without a mesh, or with another object,
    they are refused."""
    with pytest.raises(error, match=match):
        _vq_trainer(tmp_path, make_vq(jvq), **kwarg)


def test_vqmodel_training_api(jvq, tmp_path):
    """The training functions run with gradient and give the no-grad
    methods' values; dropout draws from the generator in training mode
    only; ``remat`` changes no value or gradient; ``save_pretrained`` writes
    a tree the JAX package loads; ``num_params`` counts it;
    ``create_pipeline_for_train`` builds a trainable pipeline;
    ``metrics`` equal the JAX package's."""
    vq = make_vq(jvq)
    img = torch.from_numpy(_images(70, 2))
    rec, loss = tvm.forward(vq, img)
    assert rec.requires_grad and loss.requires_grad
    rec2, loss2 = vq(img)
    assert torch.equal(rec.detach(), rec2) and float(loss) == float(loss2)
    grads = torch.autograd.grad(rec.sum() + loss, list(vq.parameters()))
    recr, lossr = tvm.forward(vq, img, remat=True)
    gradsr = torch.autograd.grad(recr.sum() + lossr, list(vq.parameters()))
    assert all(torch.allclose(a, b, atol=1e-6) for a, b in zip(grads, gradsr))

    drop = dict(SMALL_VQ, enc={**SMALL_VQ['enc'], 'dropout': 0.5})
    vqd = tvm.VQModel(drop, device='cpu')
    vqd.load_state_dict(vq.state_dict())
    assert torch.equal(tvm.forward(vqd, img)[0], rec.detach())  # eval: none
    vqd.train()
    outs = [tvm.forward(vqd, img, generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])

    path = vq.save_pretrained(str(tmp_path / 'vq.npz'))
    jm = jvm.VQModel(SMALL_VQ, seed=5).from_pretrained(path)
    assert float(np.abs(np.asarray(jm.forward(_images(70, 2))[0])
                        - _np(rec)).max()) <= 1e-5
    assert vq.num_params == jm.num_params
    a, b = _images(71, 2), _images(72, 2)
    assert abs(tmetrics.psnr(torch.from_numpy(a), b) - jmetrics.psnr(a, b)) <= 1e-4
    assert tmetrics.mae(a, b) == pytest.approx(jmetrics.mae(a, b), rel=1e-6)
    ids = np.random.default_rng(0).integers(0, 64, 300)
    assert tmetrics.codebook_stats(torch.from_numpy(ids), 64) == \
        pytest.approx(jmetrics.codebook_stats(ids, 64))
    fa, fb = a.reshape(-1, 48), b.reshape(-1, 48)  # 128 48-d "features"
    assert tmetrics.fid(fa, fb) == pytest.approx(jmetrics.fid(fa, fb),
                                                 rel=1e-6)
    pipe = pt.create_pipeline_for_train(
        'torch-port-vqgan-stage1-pipe', stage1_pretrained=False,
        text_encoder=None, device='cpu', seed=1)
    assert isinstance(pipe, tpl.Pipeline) and pipe.compute_dtype is None


# ---------------------------------------------------------------------------
# C2: which weights PaintMindTrainer's model holds under EMA
# ---------------------------------------------------------------------------

PIPE_KW = dict(stage1='torch-port-vqgan-stage1', t5='t5-l', dim=32,
               dim_head=16, mlp_dim=64, num_head=2, depth=2, t5_dim=48)


class _CaptionDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return _images(2000 + i, 1)[0], f'caption {i}'


def _embedder(captions):
    return np.stack([np.random.default_rng(len(c)).standard_normal(
        (5, 48)).astype(np.float32) for c in captions])


def _stage2_args(folder):
    return dict(num_epoch=2, valid_size=4, optim_name='adamw', lr=1e-3,
                warmup_steps=1, decay_steps=10, batch_size=8, num_workers=1,
                grad_accum_steps=1, mixed_precision='no', save_every=100,
                sample_every=100, result_folder=str(folder),
                log_dir=str(folder / 'log'), text_embedder=_embedder,
                cfg_p=0.0, ema_decay=0.9, seed=5)


def test_paintmind_trainer_holds_the_averages_as_jax_does(tmp_path,
                                                          monkeypatch):
    """``train()`` with ``ema_decay=0.9`` on both packages over the same
    data (4 updates, AdamW, the same mask ratios, the masking noise of the
    JAX step's keys, no text dropout): afterwards the port's model holds the
    averaged transformer and ``mask_token``, within 2e-5 mean abs of the
    JAX trainer's ``model.params``, and not the raw weights."""
    jcfg_ = jpl.PipelineConfig(vqc=J_CFG, dropout=0.0, **PIPE_KW)
    jparams = jax.jit(functools.partial(jpl.init_pipeline, cfg=jcfg_))(
        jax.random.PRNGKey(0))
    # the JAX trainer donates its state's buffers: keep the init on the host
    init = {k: np.array(v) for k, v in flatten_tree(jparams).items()}
    jpipe = jpl.Pipeline(jcfg_, stage1_pretrained=False, text_encoder=None,
                         params=jparams)
    ratios = [0.55, 0.8, 0.3, 0.65]
    it_j, it_t = iter(ratios), iter(ratios)
    monkeypatch.setattr(jtrainer, 'masked_p_generator', lambda: next(it_j))
    monkeypatch.setattr(ttrainer, 'masked_p_generator',
                        lambda rng=None: next(it_t))
    jt = jtrainer.PaintMindTrainer(jpipe, _CaptionDataset(20),
                                   **_stage2_args(tmp_path / 'jax'))
    keys, jstep = [], jt._step

    def record(state, *a):
        keys.append(np.asarray(state['key']).copy())
        return jstep(state, *a)

    jt._step = record
    jt.train()

    tpipe = tpl.Pipeline(tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(
        SMALL_VQ), dropout=0.0, **PIPE_KW), stage1_pretrained=False,
        text_encoder=None, device='cpu')
    load_jax_params(tpipe, init)
    tt = ttrainer.PaintMindTrainer(tpipe, _CaptionDataset(20),
                                   **_stage2_args(tmp_path / 'port'))
    tstep, it_k = tt._step, iter(keys)

    def with_jax_noise(imgs, context, ratio):
        # the JAX step: key -> (key, k_step); k_step -> one microbatch key;
        # its first split masks (jpl.pipeline_loss)
        k_step = jax.random.split(jnp.asarray(next(it_k)))[1]
        k_micro = jax.random.split(k_step, 1)[0]
        noise = np.array(jax.random.uniform(jax.random.split(k_micro)[0],
                                            (imgs.shape[0], L)))
        return tstep(imgs, context, ratio, noise=torch.from_numpy(noise))

    tt._step = with_jax_noise
    tt.train()
    assert tt.steps == jt.steps == 4
    want = to_state_dict(flatten_tree(
        {'transformer': jt.model.params['transformer'],
         'mask_token': jt.model.params['mask_token']}))
    named = dict(tpipe.named_parameters())
    for name, ref in want.items():
        diff = float(np.abs(_np(named[name]) - ref.numpy()).mean())
        assert diff <= 2e-5, (name, diff)
    for p, e in zip(tpipe.trainable_parameters(), tt.state['ema']):
        assert torch.equal(p, e)
    assert any(not torch.equal(p, r)
               for p, r in zip(tpipe.trainable_parameters(), tt._raw))


def test_paintmind_trainer_evaluate_changes_no_later_weight(tmp_path):
    """An ``evaluate()`` between two updates (which puts the averages into
    the model) leaves the later weights and averages as they are without
    it, bit for bit."""
    jparams = jax.jit(functools.partial(jpl.init_pipeline, cfg=jpl.PipelineConfig(
        vqc=J_CFG, dropout=0.0, **PIPE_KW)))(jax.random.PRNGKey(0))
    runs = []
    for with_eval in (False, True):
        pipe = tpl.Pipeline(tpl.PipelineConfig(
            vqc=tvm.VQModelConfig.from_dict(SMALL_VQ), dropout=0.1, **PIPE_KW),
            stage1_pretrained=False, text_encoder=None, device='cpu')
        load_jax_params(pipe, flatten_tree(jparams))
        args = _stage2_args(tmp_path / str(with_eval))
        args.update(valid_size=2, batch_size=4)
        trainer = ttrainer.PaintMindTrainer(pipe, _CaptionDataset(12), **args)
        batches = [b for b in trainer.train_dl][:2]
        trainer.train_step(batches[0])
        if with_eval:
            trainer.log = ttrainer.Log()
            trainer.evaluate()
            assert all(torch.equal(p, e) for p, e in zip(
                pipe.trainable_parameters(), trainer.state['ema']))
        trainer.train_step(batches[1])
        runs.append([p.detach().clone() for p in pipe.parameters()]
                    + [e.clone() for e in trainer.state['ema']])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
