"""The port's optimizers and learning-rate schedule against optax and the JAX
package, on shared seeded parameters and gradients.  Tolerance: 1e-6 max abs
on the parameters after five updates (fp32; values of order 1)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from paintmind_tpu import optim as joptim
from paintmind_tpu.optim.lr_scheduler import build_schedule as jbuild_schedule
from paintmind_tpu.utils.trainer import _micro_schedule as j_micro_schedule
from paintmind_tpu_torch import optim as toptim
from paintmind_tpu_torch.utils.trainer import _micro_schedule, \
    masked_p_generator

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

SHAPES = {'w': (7, 5), 'b': (5,), 'e': (3, 4, 2)}


def _seeded(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(make_torch, tx, grad_scale=1.0, updates=5):
    """Five updates of a torch optimizer and an optax transformation on the
    same parameters and per-update gradients; returns both results."""
    p0 = _seeded(0)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    opt = make_torch(list(tparams.values()))
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    for i in range(updates):
        grads = _seeded(100 + i, grad_scale)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        updates_, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates_)
    return tparams, jparams, opt


def _max_diff(tparams, jparams):
    return max(float(np.abs(p.detach().numpy() - np.asarray(jparams[k])).max())
               for k, p in tparams.items())


SCHED = dict(lr=1e-2, lr_min=1e-3, warmup_steps=2, warmup_lr_init=1e-4,
             decay_steps=6)


@pytest.mark.parametrize('name', ['lion', 'lion-clip', 'adamw', 'adamw-clip',
                                  'adam', 'adam-clip', 'lion-schedule'])
def test_optimizers_match_optax(name):
    """Lion (optax's order of operations), AdamW and Adam with the JAX package's
    betas, eps 1e-8 and decoupled decay; with global-norm clipping in front
    (gradients of norm ~20 against max_grad_norm 1.0, so the clip bites);
    and with a warmup-cosine schedule read per update."""
    kind, _, opt_ = name.partition('-')
    clip = 1.0 if opt_ == 'clip' else None
    lr = jbuild_schedule(**SCHED) if opt_ == 'schedule' else 1e-2
    tlr = toptim.build_schedule(**SCHED) if opt_ == 'schedule' else 1e-2
    if kind == 'lion':
        tx = joptim.lion(lr, (0.9, 0.99), weight_decay=0.05, max_grad_norm=clip)
        make = lambda ps: toptim.lion(ps, tlr, (0.9, 0.99), weight_decay=0.05,
                                      max_grad_norm=clip)
    elif kind == 'adamw':
        tx = joptim.adamw(lr, (0.9, 0.96), weight_decay=0.05, max_grad_norm=clip)
        make = lambda ps: toptim.adamw(ps, tlr, (0.9, 0.96), weight_decay=0.05,
                                       max_grad_norm=clip)
    else:
        tx = joptim.adam(lr, (0.9, 0.99), max_grad_norm=clip)
        make = lambda ps: toptim.adam(ps, tlr, (0.9, 0.99), max_grad_norm=clip)
    tparams, jparams, opt = _run_both(make, tx, grad_scale=3.0)
    diff = _max_diff(tparams, jparams)
    print(f'{name}: max abs diff after 5 updates {diff:.3e}')
    assert diff <= 1e-6
    assert opt.count == 5
    if opt_ == 'schedule':
        assert opt.param_groups[0]['lr'] == tlr(4)


def test_lion_is_a_torch_optimizer_with_state_round_trip():
    """``Lion`` steps, saves and loads like any ``torch.optim.Optimizer``;
    the update count of ``lion`` / ``adamw`` / ``adam`` travels in the state
    dict; a parameter without a gradient is left alone."""
    ps = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(2))]
    opt = toptim.lion(ps, lambda c: 0.1 / (c + 1), weight_decay=0.0)
    assert isinstance(opt, toptim.Lion) and isinstance(opt, torch.optim.Optimizer)
    ps[0].grad = torch.tensor([1.0, -2.0, 0.0, 3.0])
    opt.step()
    assert torch.allclose(ps[0], torch.tensor([0.9, 1.1, 1.0, 0.9]))
    assert torch.equal(ps[1], torch.ones(2)) and ps[1] not in opt.state
    saved = opt.state_dict()
    assert saved['count'] == 1
    ps2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = toptim.lion(ps2, lambda c: 0.1 / (c + 1), weight_decay=0.0)
    opt2.load_state_dict(saved)
    assert opt2.count == 1
    for o, pp in ((opt, ps), (opt2, ps2)):
        pp[0].grad = torch.tensor([-1.0, 1.0, 1.0, 1.0])
        o.step()
    assert torch.equal(ps[0], ps2[0])
    assert opt2.param_groups[0]['lr'] == 0.05


def test_lr_schedule_piecewise():
    """The points of the JAX package's own schedule test, and a sweep
    against ``build_schedule`` there (fp32 on that side: 1e-9 abs)."""
    sched = toptim.build_schedule(lr=1e-4, lr_min=5e-5, warmup_steps=100,
                                  warmup_lr_init=1e-6, decay_steps=1000)
    ref = jbuild_schedule(lr=1e-4, lr_min=5e-5, warmup_steps=100,
                          warmup_lr_init=1e-6, decay_steps=1000)
    assert abs(sched(0) - 1e-6) < 1e-12
    assert abs(sched(50) - (1e-6 + 50 * (1e-4 - 1e-6) / 100)) < 1e-10
    assert abs(sched(100) - 1e-4) < 1e-9      # warmup_prefix: cos starts
    assert abs(sched(100 + 500) - (5e-5 + 0.5 * (1e-4 - 5e-5))) < 1e-9
    assert abs(sched(100 + 1000) - 5e-5) < 1e-9
    assert abs(sched(5000) - 5e-5) < 1e-9     # floor after decay
    for step in (0, 1, 50, 99, 100, 101, 350, 600, 1099, 1100, 1101, 5000):
        assert abs(sched(step) - float(ref(step))) < 1e-9, step
    assert isinstance(sched(3), float)


@pytest.mark.parametrize('warmup,decay', [(0, 10), (5, 0), (0, 0)])
def test_lr_schedule_edges(warmup, decay):
    kw = dict(lr=2e-4, lr_min=1e-5, warmup_steps=warmup, warmup_lr_init=1e-6,
              decay_steps=decay)
    sched, ref = toptim.build_schedule(**kw), jbuild_schedule(**kw)
    for step in range(0, 14):
        assert abs(sched(step) - float(ref(step))) < 1e-9, step


def test_build_scheduler_and_micro_schedule():
    """``decay_steps`` defaults to num_epoch · iters; the microbatch
    timeline advances ``grad_accum`` ticks per update, as in the JAX
    trainer."""
    a = toptim.build_scheduler(3, 40, 1e-4, 1e-5, 10, 1e-6)
    b = toptim.build_schedule(1e-4, 1e-5, 10, 1e-6, 120)
    assert [a(s) for s in (0, 9, 10, 70, 130, 200)] == \
        [b(s) for s in (0, 9, 10, 70, 130, 200)]
    assert toptim.lr_scheduler.build_scheduler is toptim.build_scheduler
    assert _micro_schedule(a, 1) is a
    micro, jmicro = _micro_schedule(a, 4), j_micro_schedule(a, 4)
    assert [micro(c) for c in range(5)] == [a(4 * c) for c in range(5)] == \
        [jmicro(c) for c in range(5)]


def test_masked_p_generator_is_arccos_distributed():
    rng = np.random.default_rng(0)
    draws = np.asarray([masked_p_generator(rng) for _ in range(4000)])
    assert draws.min() > 0 and draws.max() <= 1
    # P(cos(pi/2 U) <= x) = 1 - 2/pi arccos(x)
    for x in (0.25, 0.5, 0.75):
        assert abs((draws <= x).mean() - (1 - 2 / np.pi * np.arccos(x))) < 0.03
    np.random.seed(1)
    assert 0 < masked_p_generator() <= 1
