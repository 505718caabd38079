"""Port nn primitives, blocks and the weight bridge held against the JAX
package on the CPU, in fp32.  Inputs and parameters come from seeded numpy
or JAX inits; the JAX tree reaches the port through
``flatten_tree`` -> ``convert.from_jax``.  Tolerance: 1e-5 max abs.
``LayerNorm``'s one pass is held against its fp32 form in bf16, fp16 and
fp32."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp

from paintmind_tpu.nn import attention as jatt
from paintmind_tpu.nn import core as jcore
from paintmind_tpu.nn import mlp as jmlp
from paintmind_tpu.nn import transformer as jtr
from paintmind_tpu.utils.checkpoint import flatten_tree, save_params
from paintmind_tpu_torch.convert.from_jax import load_jax_params
from paintmind_tpu_torch.nn import attention as tatt
from paintmind_tpu_torch.nn import core as tcore
from paintmind_tpu_torch.nn import mlp as tmlp
from paintmind_tpu_torch.nn import transformer as ttr
from paintmind_tpu_torch.utils import profiling
from paintmind_tpu_torch.utils.checkpoint import load_flat

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

TOL = 1e-5


def _port(module, jax_params):
    return load_jax_params(module.eval(), flatten_tree(jax_params))


def _close(got, ref, tol=TOL):
    err = float(np.abs(got.detach().numpy() - np.asarray(ref)).max())
    assert err <= tol, err


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_linear_layernorm_swiglu(rng):
    x = _x(rng, 2, 5, 24)
    p = jcore.init_linear(jax.random.PRNGKey(0), 24, 40)
    _close(_port(tcore.Linear(24, 40), p)(torch.from_numpy(x)),
           jcore.linear(p, jnp.asarray(x)))

    ln = {'scale': jnp.asarray(_x(rng, 24)), 'bias': jnp.asarray(_x(rng, 24))}
    _close(_port(tcore.LayerNorm(24), ln)(torch.from_numpy(x * 30)),
           jcore.layernorm(ln, jnp.asarray(x * 30)))

    assert tmlp.swiglu_hidden_dim(2048) == jmlp.swiglu_hidden_dim(2048) == 1368
    assert tmlp.swiglu_hidden_dim(4096) == jmlp.swiglu_hidden_dim(4096)
    p = jmlp.init_swiglu(jax.random.PRNGKey(1), 24, 64)
    _close(_port(tmlp.SwiGLU(24, 64), p)(torch.from_numpy(x)),
           jmlp.swiglu(p, jnp.asarray(x)))


def _ulps(a, b):
    """Distance in units of the last place, element by element, between two
    tensors of one floating type (-0 and +0 are 0 apart)."""
    bits = {2: (torch.int16, 0x7FFF), 4: (torch.int32, 0x7FFFFFFF)}
    ints, mag = bits[a.element_size()]

    def ordered(t):
        i = t.view(ints).long()
        return torch.where(i < 0, -(i & mag), i)
    return (ordered(a) - ordered(b)).abs()


def _fp32_form(x, w, b):
    """``LayerNorm``'s fp32 form, written out: x, weight and bias widened
    to fp32, the result rounded to x's type."""
    return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(),
                        1e-5).to(x.dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layernorm_one_pass(dtype):
    """Parameters in the activations' type: one ``F.layer_norm`` call, the
    fp32 form's value (fp32 bit-equal; bf16 and fp16 within one ulp on the
    CPU, whose reduced-type kernel sums in another order), counted as
    ``pm.norm.one_pass``.  fp32 parameters under bf16 or fp16 activations:
    the fp32 form's bits and gradients, counted as ``pm.norm.fp32_copies``.
    Nothing counts with recording off."""
    g = torch.Generator().manual_seed(3)
    d = 1024
    x = (3 * torch.randn(4, 77, d, generator=g) + 0.5).to(dtype)
    masters = tcore.LayerNorm(d)
    with torch.no_grad():
        masters.weight.copy_(1 + 0.1 * torch.randn(d, generator=g))
        masters.bias.copy_(0.1 * torch.randn(d, generator=g))
    same = copy.deepcopy(masters).to(dtype)
    profiling.reset()
    with profiling.recording():
        got = same(x)
        counts = profiling.snapshot()['counters']
    assert counts == {'pm.norm.one_pass': 1.0}
    want = _fp32_form(x, same.weight, same.bias)
    assert got.dtype == dtype
    ulps = _ulps(got, want)
    print(f'{dtype}: {int((ulps > 0).sum())} of {got.numel()} elements one '
          f'ulp off the fp32 form')
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert int(ulps.max()) <= 1

    if dtype != torch.float32:
        xg = x.clone().requires_grad_()
        profiling.reset()
        with profiling.recording():
            got = masters(xg)
            counts = profiling.snapshot()['counters']
        assert counts == {'pm.norm.fp32_copies': 1.0}
        w = masters.weight.detach().clone().requires_grad_()
        b = masters.bias.detach().clone().requires_grad_()
        xr = x.clone().requires_grad_()
        want = _fp32_form(xr, w, b)
        assert got.dtype == dtype and torch.equal(got, want)
        up = torch.randn(got.shape, generator=g).to(dtype)
        got.backward(up)
        want.backward(up)
        assert masters.weight.grad.dtype == masters.bias.grad.dtype \
            == torch.float32
        assert torch.equal(masters.weight.grad, w.grad)
        assert torch.equal(masters.bias.grad, b.grad)
        assert torch.equal(xg.grad, xr.grad)
        assert masters.weight.grad.abs().sum() > 0

    profiling.reset()
    same(x)
    masters(x)
    assert profiling.snapshot()['counters'] == {}


@pytest.mark.parametrize('context_dim', [None, 32, 40])
def test_attention(rng, context_dim):
    """Self- and cross-attention, plain and through the CPU flash wrapper,
    and (context_dim == query dim, as in the stage-2 blocks) the CFG-halves
    form."""
    p = jatt.init_attention(jax.random.PRNGKey(2), 32,
                            context_dim=context_dim, heads=2, dim_head=16)
    m = _port(tatt.Attention(32, context_dim=context_dim, heads=2,
                             dim_head=16), p)
    x = _x(rng, 2, 12, 32)
    ctx = None if context_dim is None else _x(rng, 2, 7, context_dim)
    ref = jatt.attention(p, jnp.asarray(x),
                         None if ctx is None else jnp.asarray(ctx),
                         heads=2, backend='xla')
    tctx = None if ctx is None else torch.from_numpy(ctx)
    for backend in ('plain', 'flash', 'auto'):
        _close(m(torch.from_numpy(x), tctx, backend=backend), ref)
    if context_dim == 32:
        both = np.concatenate([x, x], axis=0)
        ref_h = jatt.attention_cfg_halves(p, jnp.asarray(both),
                                          jnp.asarray(ctx), heads=2,
                                          backend='xla')
        _close(m.forward_cfg_halves(torch.from_numpy(both), tctx), ref_h)


def test_attention_backend_switch():
    assert tatt.get_attention_backend() == 'auto'
    with pytest.raises(ValueError):
        tatt.set_attention_backend('xla')
    tatt.set_attention_backend('plain')
    try:
        assert tatt.get_attention_backend() == 'plain'
    finally:
        tatt.set_attention_backend('auto')


@pytest.mark.parametrize('cross', [False, True])
def test_block_and_stack(rng, cross):
    """One block and a depth-3 stack (leading depth axis unstacked by the
    bridge), with and without a context, and the cfg_halves branch."""
    kw = dict(dim_head=16, mlp_dim=64, num_head=2, cross=cross,
              context_dim=32 if cross else None)
    bp = jtr.init_block(jax.random.PRNGKey(3), 32, **kw)
    block = _port(ttr.Block(32, **kw), bp)
    sp = jtr.init_stack(jax.random.PRNGKey(4), 3, 32, **kw)
    holder = nn.Module()
    holder.layers = ttr.make_stack(3, 32, **kw)
    _port(holder, {'layers': sp})

    x = _x(rng, 2, 10, 32)
    ctx = _x(rng, 2, 6, 32) if cross else None
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    _close(block(torch.from_numpy(x), tctx),
           jtr.block_apply(bp, jnp.asarray(x), jctx, heads=2, backend='xla'))
    _close(ttr.stack_apply(holder.layers, torch.from_numpy(x), tctx),
           jtr.stack_apply(sp, jnp.asarray(x), jctx, heads=2, backend='xla'))
    if cross:
        both = np.concatenate([x, x], axis=0)
        _close(ttr.stack_apply(holder.layers, torch.from_numpy(both), tctx,
                               cfg_halves=True),
               jtr.stack_apply(sp, jnp.asarray(both), jctx, heads=2,
                               backend='xla', cfg_halves=True))


def test_bridge_rejects_mismatched_trees():
    p = jcore.init_linear(jax.random.PRNGKey(5), 8, 4)
    with pytest.raises(KeyError):
        load_jax_params(tcore.Linear(8, 4, bias=False), flatten_tree(p))
    with pytest.raises(KeyError):
        load_jax_params(tcore.Linear(8, 4), {'kernel': np.zeros((8, 4))})
    with pytest.raises(ValueError):
        load_jax_params(tcore.Linear(8, 4), flatten_tree(
            jcore.init_linear(jax.random.PRNGKey(5), 8, 5)))


def test_npz_bf16_tags_and_fp16(tmp_path, rng):
    """load_flat resolves the ``::bf16`` uint16 tag, the pre-tag raw 'V2'
    bf16 artifact and plain fp16/fp32 leaves to the same values JAX holds."""
    tree = {'a': jnp.asarray(_x(rng, 3, 4), jnp.bfloat16),
            'b': {'c': jnp.asarray(_x(rng, 5), jnp.float16),
                  'd': jnp.asarray(_x(rng, 2, 2))}}
    path = str(tmp_path / 'p.npz')
    save_params(path, tree)
    flat = load_flat(path)
    assert flat['a'].dtype == torch.bfloat16 and set(flat) == {'a', 'b/c', 'b/d'}
    np.testing.assert_array_equal(flat['a'].float().numpy(),
                                  np.asarray(tree['a'], np.float32))
    assert flat['b/c'].dtype == torch.float16
    np.testing.assert_array_equal(flat['b/d'].numpy(), np.asarray(tree['b']['d']))
    raw = str(tmp_path / 'v2.npz')
    np.savez(raw, a=np.asarray(tree['a']).view(np.uint16).view('V2'))
    np.testing.assert_array_equal(load_flat(raw)['a'].float().numpy(),
                                  np.asarray(tree['a'], np.float32))
    # reference .pt state dicts are converted on load (test_torch_convert.py);
    # an orbax directory is refused
    with pytest.raises(NotImplementedError):
        load_flat(str(tmp_path / 'orbax_checkpoint'))
