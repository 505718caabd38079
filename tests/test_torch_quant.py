"""The port's int8 quantization (``paintmind_tpu_torch/nn/quant.py``,
``Pipeline.quantize``, the server's ``--quantize``) held against the JAX
package's (``paintmind_tpu/nn/quant.py``) on the CPU.

Tolerances: int8 kernels and fp32 scales bit-equal (the same fp32 ops in
the same order); ``w8a8`` outputs bit-equal to JAX's compiled ``linear_q``
without a bias (exact int32 accumulators, the same fp32 scale products)
and within one unit in the last place with one (XLA fuses the bias add
into an FMA); ``w8`` within 1e-5
relative (a floating-point product, summed in another order); quantized
logits of a tiny pipeline within 1e-5 max abs in fp32 and 3e-2 mean
relative in bf16; sampled ids on JAX's Gumbel noise equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.nn import quant as jq
from paintmind_tpu.utils.checkpoint import flatten_tree
import paintmind_tpu_torch as pt
from paintmind_tpu_torch.convert.from_jax import load_jax_params, to_flat
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.nn import quant as tq
from paintmind_tpu_torch.nn.core import Linear

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
PIPE = {'stage1': 'torch-quant-vqgan', 't5': 't5-l', 'dim': 32,
        'dim_head': 16, 'mlp_dim': 64, 'num_head': 2, 'depth': 2,
        'dropout': 0.0}
for _reg in (jcfg, pt):
    _reg.register_version('torch-quant-vqgan', SMALL_VQ)
    _reg.register_version('torch-quant-pipeline', PIPE)
J_CFG = jpl.PipelineConfig.from_dict(jcfg.ver2cfg['torch-quant-pipeline'])
T_CFG = tpl.PipelineConfig.from_dict(pt.ver2cfg['torch-quant-pipeline'])
L, V, MASK = J_CFG.num_tokens, J_CFG.vqc.n_embed, J_CFG.mask_token_id
MIN_DIM = 16  # the tiny widths (32, 48, 96) all qualify


def _np(t):
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def _jpipe(seed=0, dtype=None):
    return jpl.Pipeline(config=J_CFG, stage1_pretrained=False,
                        text_encoder=None, seed=seed, compute_dtype=dtype)


def _tpipe(jpipe, dtype=None):
    p = tpl.Pipeline(T_CFG, stage1_pretrained=False, text_encoder=None,
                     device='cpu', compute_dtype=dtype)
    return load_jax_params(p, flatten_tree(jpipe.params))


def _kernel(shape, seed):
    k = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    k[..., 3] = 0.0  # an all-zero output channel: the 1e-12 floor
    return k


@pytest.mark.parametrize('mode', ['w8', 'w8a8'])
@pytest.mark.parametrize('shape', [(48, 40), (3, 48, 40)],
                         ids=['2d', 'stacked'])
def test_quantize_weight_bit_equal(mode, shape):
    """int8 kernels and fp32 scales equal JAX's ``quantize_linear`` bit for
    bit, per (depth, out) for a depth-stacked (depth, in, out) kernel."""
    k = _kernel(shape, len(shape))
    want = jq.quantize_linear({'kernel': jnp.asarray(k)}, mode)
    wq, scale = tq.quantize_weight(torch.from_numpy(k).transpose(-1, -2))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(_np(wq.transpose(-1, -2)),
                                  np.asarray(want['kernel_q']))
    np.testing.assert_array_equal(_np(scale), np.asarray(want['scale']))
    assert ('dyn' in want) == (mode == 'w8a8')
    if len(shape) == 2:  # the module form
        lin = Linear(shape[0], shape[1], device='cpu')
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(k.T))
        q = tq.quantize_linear(lin, mode)
        assert tq.is_quantized(q) and not tq.is_quantized(lin)
        assert hasattr(q, 'dyn') == (mode == 'w8a8')
        np.testing.assert_array_equal(_np(q.kernel_q), _np(wq))
        back = tq.dequantize_linear(q)
        want_back = jq.dequantize_linear(want)
        np.testing.assert_array_equal(_np(back.weight).T,
                                      np.asarray(want_back['kernel']))


def _linear_case(dtype, seed=5):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((64, 96)).astype(np.float32) * 0.1
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((3, 24, 64)).astype(np.float32) * 2.0
    x[0, 0] = 0.0  # a zero token: the 1e-12 floor of the token scale
    jp = jq.quantize_linear({'kernel': jnp.asarray(k), 'bias': jnp.asarray(b)},
                            'w8a8')
    jx = jnp.asarray(x, dtype)
    lin = Linear(64, 96, device='cpu')
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(k.T))
        lin.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return jp, jx, lin, tx


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_linear_q_w8a8_matches_jax(dtype):
    """``w8a8`` on the same inputs against JAX's compiled ``linear_q`` (the
    form its jitted samplers run; XLA turns ``amax / 127`` into a product
    with the fp32 reciprocal, which the port computes on both devices).
    Without a bias: bit-equal (exact int32 accumulators, the same fp32
    products).  With one: within one unit in the last place of the larger
    of the scaled product and the output, because XLA's CPU code fuses the
    last scale product and the bias add into one FMA (one rounding) where
    the port rounds twice."""
    jp, jx, lin, tx = _linear_case(getattr(jnp, dtype))
    q = tq.quantize_linear(lin, 'w8a8')
    assert q(tx).dtype == tx.dtype
    bare = {k: v for k, v in jp.items() if k != 'bias'}
    q.bias = None
    np.testing.assert_array_equal(
        _np(q(tx)), np.asarray(jax.jit(jq.linear_q)(bare, jx).astype(
            jnp.float32)))
    q = tq.quantize_linear(lin, 'w8a8')
    got = _np(q(tx))
    bias = np.asarray(jp['bias'].astype(jx.dtype).astype(jnp.float32))
    want = np.asarray(jax.jit(jq.linear_q)(jp, jx).astype(jnp.float32))
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(want - bias)))
    if dtype == 'bfloat16':
        ulp = ulp * 2 ** 16  # bf16 keeps 8 of fp32's 24 significand bits
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    # the accumulators themselves: an exact product
    xq, _ = tq.quantize_activations(tx)
    acc = tq.int8_matmul(xq.reshape(-1, 64), q.kernel_q)
    ref = xq.reshape(-1, 64).numpy().astype(np.int64) @ \
        q.kernel_q.numpy().astype(np.int64).T
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), ref)


def test_linear_q_w8_matches_jax():
    """Weight-only: within 1e-5 relative of JAX's (fp32 products)."""
    jp, jx, lin, tx = _linear_case(jnp.float32, seed=6)
    jp = jq.quantize_linear({'kernel': jp['kernel_q'].astype(jnp.float32)
                             * jp['scale'], 'bias': jp['bias']}, 'w8')
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(jq.dequantize_linear(
            jp)['kernel']).T))
    q = tq.quantize_linear(lin, 'w8')
    want = np.asarray(jq.linear_q(jp, jx))
    got = _np(q(tx))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel


def test_int_mm_rules_and_refusals():
    """The card's int8 product's shape rules, and the refusals of a mode
    that does not exist and of floating operands."""
    assert tq.int_mm_shape_error(17, 64, 96) is None
    assert 'more than 16' in tq.int_mm_shape_error(16, 64, 96)
    assert 'multiple of 8' in tq.int_mm_shape_error(32, 60, 96)
    assert 'multiple of 8' in tq.int_mm_shape_error(32, 64, 90)
    with pytest.raises(ValueError, match='quantization mode'):
        tq.quantize_linear(Linear(8, 8, device='cpu'), 'w4')
    with pytest.raises(TypeError, match='int8 operands'):
        tq.int8_matmul(torch.ones(20, 8), torch.ones(8, 8, dtype=torch.int8))


_PAIRS = {}


def _quantized_pair(mode, bf16=False):
    """A quantized JAX pipeline and the port's of the same weights, built
    once per (mode, dtype): no test changes them."""
    if (mode, bf16) not in _PAIRS:
        jp = _jpipe(0, jnp.bfloat16 if bf16 else None)
        tp = _tpipe(jp, torch.bfloat16 if bf16 else None)
        jp.quantize(mode, min_dim=MIN_DIM)
        tp.quantize(mode, min_dim=MIN_DIM)
        _PAIRS[mode, bf16] = jp, tp
    return _PAIRS[mode, bf16]


@pytest.mark.parametrize('mode', ['w8', 'w8a8'])
def test_pipeline_quantize_tree_matches_jax(mode):
    """``Pipeline.quantize``'s ``to_flat`` tree has JAX's keys, dtypes and
    shapes (``dyn`` (depth, 0) under ``layers``, (0,) for ``to_logits``)
    and its values bit for bit; the VQGAN and the small linears stay
    floating point; ``num_params`` counts JAX's leaves."""
    jp, tp = _quantized_pair(mode)
    want = flatten_tree(jp.params)
    got = to_flat(tp)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert ('transformer/layers/attn1/to_q/dyn' in got) == (mode == 'w8a8')
    if mode == 'w8a8':
        assert got['transformer/layers/ffnet/w12/dyn'].shape == (2, 0)
        assert got['transformer/to_logits/dyn'].shape == (0,)
    assert 'transformer/token_proj/kernel' in got  # 8 -> 32: below min_dim
    assert tp.num_params == jp.num_params


@pytest.mark.parametrize('mode', ['w8', 'w8a8'])
def test_quantized_logits_and_ids_match_jax(mode):
    """Quantized transformer logits within 1e-5 max abs of JAX's (fp32),
    guided ones too; a 3-step ``generate_ids`` on JAX's Gumbel noise gives
    equal ids and trajectory."""
    jp, tp = _quantized_pair(mode)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, V, (2, L)).astype(np.int32)
    ids[:, ::3] = MASK
    ctx = rng.standard_normal((2, 5, 1024)).astype(np.float32)
    jtok = jpl.ids_to_tokens(jp.params, jnp.asarray(ids), J_CFG)
    ttok = tpl.ids_to_tokens(tp, torch.from_numpy(ids), T_CFG)
    for gs in (None, 2.5):
        want = np.asarray(jpl._transformer_logits(
            jp.params, jtok, jnp.asarray(ctx), gs, cfg=J_CFG, backend='xla'))
        got = _np(tpl._transformer_logits(tp, ttok, torch.from_numpy(ctx), gs,
                                          cfg=T_CFG))
        assert np.abs(got - want).max() <= 1e-5, (gs, np.abs(got - want).max())
    key = jax.random.PRNGKey(3)
    init = np.full((2, L), MASK, np.int32)
    jf, jt = jpl.generate_ids(jp.params, key, jnp.asarray(init),
                              jnp.asarray(ctx), cfg=J_CFG, timesteps=3,
                              topk=3, backend='xla')
    noise = torch.from_numpy(np.stack([
        np.array(jpl._gumbel(k, (2, L, V)))
        for k in jax.random.split(key, 3)]))
    tf, tt = tpl.generate_ids(tp, torch.from_numpy(init), torch.from_numpy(ctx),
                              cfg=T_CFG, timesteps=3, topk=3, noise=noise)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))


def test_bf16_quantized_pipeline():
    """A bf16 pipeline keeps fp32 scales through ``quantize`` and later
    ``.to()`` calls, equal to JAX's (which keep theirs in ``_maybe_cast``);
    its logits are within 3e-2 mean relative of JAX's bf16 ones;
    ``num_params`` equals JAX's leaf count."""
    jp, tp = _quantized_pair('w8a8', bf16=True)
    q = tp.transformer.layers[0].attn1.to_q
    assert q.scale.dtype == torch.float32 and q.kernel_q.dtype == torch.int8
    before = q.scale.clone()
    tp.to(torch.bfloat16)
    tp.to('cpu', torch.float16)
    tp.to(torch.bfloat16)
    assert q.scale.dtype == torch.float32 and torch.equal(q.scale, before)
    assert tp.transformer.to_logits.bias.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(q.scale),
        np.asarray(jp.params['transformer']['layers']['attn1']['to_q']
                   ['scale'][0]))
    assert jp.params['transformer']['to_logits']['scale'].dtype == jnp.float32
    assert tp.num_params == jp.num_params
    rng = np.random.default_rng(8)
    ids = rng.integers(0, V, (2, L)).astype(np.int32)
    ctx = rng.standard_normal((2, 5, 1024)).astype(np.float32)
    want = np.asarray(jpl._transformer_logits(
        jp.params, jpl.ids_to_tokens(jp.params, jnp.asarray(ids), J_CFG),
        jnp.asarray(ctx), None, cfg=J_CFG, backend='xla',
        dtype=jnp.bfloat16).astype(jnp.float32))
    got = _np(tpl._transformer_logits(
        tp, tpl.ids_to_tokens(tp, torch.from_numpy(ids), T_CFG),
        torch.from_numpy(ctx), None, cfg=T_CFG, dtype=torch.bfloat16))
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert rel <= 3e-2, rel


@pytest.mark.parametrize('mode', ['w8', 'w8a8'])
def test_quantized_checkpoint_round_trip_with_jax(mode, tmp_path):
    """The port's quantized ``save_pretrained`` loads into a quantized JAX
    pipeline bit-exactly, and JAX's into a quantized port pipeline."""
    jp, tp = _quantized_pair(mode)
    path = str(tmp_path / 'port.npz')
    tp.save_pretrained(path)
    other = _jpipe(seed=9).quantize(mode, min_dim=MIN_DIM)
    other.from_pretrained(path)
    for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(other.params),
                          jax.tree_util.tree_leaves(jp.params)):
        assert a.dtype == b.dtype, kp
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jpath = str(tmp_path / 'jax.npz')
    jp.save_pretrained(jpath)
    fresh = _tpipe(_jpipe(seed=10)).quantize(mode, min_dim=MIN_DIM)
    fresh.from_pretrained(jpath)
    for (k, a), (_, b) in zip(fresh.state_dict().items(),
                              tp.state_dict().items()):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k


def _message(call):
    with pytest.raises(Exception) as caught:
        call()
    return caught.type, str(caught.value)


def test_refusals_carry_jax_messages(tmp_path):
    """MoE, a second ``quantize`` and a floating-point checkpoint into a
    quantized pipeline raise JAX's exceptions with JAX's messages."""
    moe = dict(PIPE, num_experts=4)
    jcfg.register_version('torch-quant-moe', moe)
    pt.register_version('torch-quant-moe', moe)
    jm = jpl.Pipeline(config=jpl.PipelineConfig.from_dict(moe),
                      stage1_pretrained=False, text_encoder=None)
    tm = tpl.Pipeline(tpl.PipelineConfig.from_dict(moe),
                      stage1_pretrained=False, text_encoder=None,
                      device='cpu')
    want = _message(lambda: jm.quantize('w8a8'))
    assert want[0] is NotImplementedError
    assert _message(lambda: tm.quantize('w8a8')) == want

    jp, tp = _quantized_pair('w8a8')
    want = _message(lambda: jp.quantize('w8'))
    assert want[0] is RuntimeError
    assert _message(lambda: tp.quantize('w8')) == want

    fp = str(tmp_path / 'fp.npz')
    _jpipe(seed=5).save_pretrained(fp)
    want = _message(lambda: jp.from_pretrained(fp))
    got = _message(lambda: tp.from_pretrained(fp))
    assert got[0] is want[0] is RuntimeError
    # the message names the inner error, whose text differs per package
    assert got[1].split(' (')[0] == want[1].split(' (')[0]
    assert got[1].split(') ')[-1] == want[1].split(') ')[-1]
    w8 = str(tmp_path / 'w8.npz')
    _tpipe(_jpipe(seed=6)).quantize('w8', min_dim=MIN_DIM).save_pretrained(w8)
    assert _message(lambda: tp.from_pretrained(w8))[0] is RuntimeError


def test_serving_quantize_flag_and_engine(monkeypatch):
    """``python -m paintmind_tpu_torch.serving --quantize w8a8 --device
    cpu`` builds a quantized pipeline and hands it to the server; a
    ``GenerationEngine`` over a quantized pipeline serves three seeded
    requests as one padded batch of 4 whose images equal
    ``Pipeline.generate`` of that batch, bit for bit."""
    from paintmind_tpu_torch.serving import server
    from paintmind_tpu_torch.serving.__main__ import main
    from paintmind_tpu_torch.serving import GenerateRequest, GenerationEngine
    from paintmind_tpu_torch.serving.engine import fold_seeds
    served = {}
    monkeypatch.setattr(server, 'serve',
                        lambda pipe, *a, **kw: served.update(pipe=pipe, kw=kw))
    main(['--version', 'torch-quant-pipeline', '--quantize', 'w8a8',
          '--no-text-encoder', '--device', 'cpu', '--timesteps', '3'])
    pipe = served['pipe']
    assert pipe._quantized == 'w8a8' and served['kw']['defaults'] == {
        'timesteps': 3, 'topk': 5}
    # default min_dim 64: the tiny blocks stay fp, the (32, 64) head is int8
    assert isinstance(pipe.transformer.to_logits, tq.QLinear)
    assert isinstance(pipe.transformer.layers[0].attn1.to_q, Linear)

    _, tp = _quantized_pair('w8a8')
    ctx = np.random.default_rng(12).standard_normal((3, 5, 1024)).astype(
        np.float32)
    seeds = [7, 8, 9]
    with GenerationEngine(tp, max_batch=4, max_wait_ms=300) as eng:
        futs = [eng.submit(GenerateRequest(context=ctx[i], seed=seeds[i],
                                           timesteps=3, topk=3))
                for i in range(3)]
        got = [f.result(timeout=300) for f in futs]
        stats = eng.stats()
    assert stats['batches'] == 1 and stats['padded_slots'] == 1
    direct = tp.generate(
        text=np.concatenate([ctx, ctx[:1]]), timesteps=3, topk=3,
        temperature=np.ones(4, np.float32), decode_steps='final',
        generator=torch.Generator().manual_seed(fold_seeds(seeds)))[-1]
    for i in range(3):
        np.testing.assert_array_equal(got[i], _np(direct[i]))
