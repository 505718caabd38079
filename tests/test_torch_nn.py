"""Port nn primitives, blocks and the weight bridge held against the JAX
package on the CPU, in fp32.  Inputs and parameters come from seeded numpy
or JAX inits; the JAX tree reaches the port through
``flatten_tree`` -> ``convert.from_jax``.  Tolerance: 1e-5 max abs."""

import numpy as np
import pytest
import torch
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
from paintmind_tpu_torch.utils.checkpoint import load_flat

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
    with pytest.raises(NotImplementedError):
        load_flat(str(tmp_path / 'model.pt'))
