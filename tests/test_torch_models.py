"""The port's models and sampler held against the JAX package on the CPU.

Small configurations (``SMALL_VQ`` / ``SMALL_PIPE``, with t5_dim != dim so
``context_proj`` runs); parameters are JAX inits carried over by the weight
bridge.  The exact sampler is fed the Gumbel noise JAX draws
(``pipeline._gumbel`` on ``jax.random.split(key, T)``), so ids and
trajectories must be bit-equal.  Tolerances: encode ids equal; decoder
outputs 1e-5 MAE; logits 1e-5 max abs; the shipped full-width stage-1
weights 1e-4 MAE with >= 99.9 % equal ids (mismatches only at near-ties)."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.utils import checkpoint as jck
from paintmind_tpu.utils.checkpoint import flatten_tree
import paintmind_tpu_torch as pt
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.convert.from_jax import load_jax_params
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import vqmodel as tvm

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, 'paintmind_tpu', 'assets', 'vit_vq_photo.npz')

SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
jcfg.register_version('torch-port-vqgan', SMALL_VQ)
tcfg.register_version('torch-port-vqgan', SMALL_VQ)
PIPE_KW = dict(stage1='torch-port-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, depth=2, dropout=0.0, t5_dim=48)
J_PIPE = jpl.PipelineConfig(vqc=jvm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)
T_PIPE = tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)
L = J_PIPE.num_tokens
V = J_PIPE.vqc.n_embed
MASK = J_PIPE.mask_token_id


def _mae(a, b):
    return float(np.mean(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope='module')
def jparams():
    return jpl.init_pipeline(jax.random.PRNGKey(0), J_PIPE)


@pytest.fixture(scope='module')
def tpipe(jparams):
    pipe = tpl.Pipeline(T_PIPE, stage1_pretrained=False, text_encoder=None,
                        device='cpu')
    return load_jax_params(pipe, flatten_tree(jparams))


def _images(seed, b):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)


def test_bridge_round_trip(jparams, tpipe):
    """init_pipeline -> flatten_tree -> port: every key consumed, every
    parameter filled; kernels transposed, stacks split per layer."""
    flat = flatten_tree(jparams)
    assert len(tpipe.state_dict()) > len(flat)  # stacks unstacked
    w = jparams['transformer']['layers']['attn1']['to_q']['kernel']
    np.testing.assert_array_equal(
        _np(tpipe.transformer.layers[1].attn1.to_q.weight), np.asarray(w[1]).T)
    np.testing.assert_array_equal(_np(tpipe.mask_token),
                                  np.asarray(jparams['mask_token']))
    np.testing.assert_array_equal(
        _np(tpipe.vqgan.quantize.codebook),
        np.asarray(jparams['vqgan']['quantize']['codebook']))
    assert hasattr(tpipe.transformer, 'context_proj')


def test_vqmodel_parity(jparams, tpipe):
    """encode ids equal; z_q, forward, decode and decode_from_indice within
    1e-5 MAE; NCHW input accepted like the JAX model."""
    vqp, cfg = jparams['vqgan'], J_PIPE.vqc
    vq = tpipe.vqgan
    img = _images(1, 3)
    jz, jloss, jids = jvm.encode(vqp, jnp.asarray(img), cfg, backend='xla')
    z, loss, ids = vq.encode(img)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    assert ids.dtype == torch.int32
    assert _mae(_np(z), jz) <= 1e-5 and abs(float(loss) - float(jloss)) <= 1e-5
    jrec, _ = jvm.forward(vqp, jnp.asarray(img), cfg, backend='xla')
    rec, _ = vq(img)
    assert rec.shape == (3, 32, 32, 3) and _mae(_np(rec), jrec) <= 1e-5
    assert _mae(_np(vq.reconstruct(img.transpose(0, 3, 1, 2))), jrec) <= 1e-5
    assert _mae(_np(vq.decode(z)), jvm.decode(vqp, jz, cfg)) <= 1e-5
    assert _mae(_np(vq.decode_from_indice(ids)),
                jvm.decode_from_indice(vqp, jids, cfg)) <= 1e-5
    plain = vq.reconstruct(img, backend='plain', vq_backend='plain')
    assert torch.equal(plain, rec)


def _logits_ref(jparams, tokens, ctx, gs, neg=None):
    return np.asarray(jpl._transformer_logits(
        jparams, jnp.asarray(tokens), None if ctx is None else jnp.asarray(ctx),
        gs, cfg=J_PIPE, backend='xla',
        neg_context=None if neg is None else jnp.asarray(neg)))


@pytest.mark.parametrize('case', ['cond', 'uncond', 'fused-cfg', 'two-pass-cfg',
                                  'per-sample-cfg', 'negative'])
def test_transformer_logits(jparams, tpipe, case):
    """CondTransformer logits for every branch of _transformer_logits:
    1e-5 max abs (B = 9 takes the two-pass guided branch)."""
    rng = np.random.default_rng(len(case))
    b = 9 if case == 'two-pass-cfg' else 2
    tokens = rng.standard_normal((b, L, 8)).astype(np.float32)
    ctx = None if case == 'uncond' else \
        rng.standard_normal((b, 5, 48)).astype(np.float32)
    gs = {'cond': None, 'uncond': None, 'per-sample-cfg':
          np.asarray([1.5, 4.0], np.float32)}.get(case, 3.0)
    neg = rng.standard_normal((b, 5, 48)).astype(np.float32) \
        if case == 'negative' else None
    ref = _logits_ref(jparams, tokens, ctx, gs, neg)
    got = tpl._transformer_logits(
        tpipe, torch.from_numpy(tokens),
        None if ctx is None else torch.from_numpy(ctx), gs, cfg=T_PIPE,
        neg_context=None if neg is None else torch.from_numpy(neg))
    assert got.shape == (b, L, V)
    assert float(np.abs(_np(got) - ref).max()) <= 1e-5


def _noise(key, timesteps, b):
    keys = jax.random.split(key, timesteps)
    return [np.array(jpl._gumbel(k, (b, L, V))) for k in keys]


def test_sample_step_exact_bit_equal(jparams, tpipe):
    """One exact-sampler step on a partly masked batch, with JAX's noise:
    ids_next and pred bit-equal, scalar and per-sample temperature, plain
    and clamped re-mask."""
    rng = np.random.default_rng(4)
    ids0 = rng.integers(0, V, (2, L)).astype(np.int32)
    ids0[rng.random((2, L)) > 0.4] = MASK
    ctx = rng.standard_normal((2, 5, 48)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    noise = np.array(jpl._gumbel(key, (2, L, V)))
    for temp, gs, clamp, n_m in ((0.7, None, False, 6),
                                 (np.asarray([0.3, 1.2], np.float32), 2.0,
                                  True, 20)):
        jn, jp = jpl.sample_step(
            jparams, jnp.asarray(ids0), key, context=jnp.asarray(ctx),
            n_masked=n_m, temperature=temp, topk=3, cfg=J_PIPE,
            guidance_scale=gs, backend='xla', sampler='exact',
            clamp_remask=clamp)
        tn, tp_ = tpl.sample_step(
            tpipe, torch.from_numpy(ids0), context=torch.from_numpy(ctx),
            n_masked=n_m, temperature=temp, topk=3, cfg=T_PIPE,
            guidance_scale=gs, sampler='exact', clamp_remask=clamp,
            noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(_np(tp_), np.asarray(jp))
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))
        assert tn.dtype == torch.int32


@pytest.mark.parametrize('mode', ['uncond-merged', 'cond-preds',
                                  'guided-warmup'])
def test_generate_ids_bit_equal(jparams, tpipe, mode):
    """4-step decode with JAX's per-step noise: final ids and trajectory
    bit-equal for both trajectory modes, unguided, conditional, and guided
    with cfg_warmup."""
    b, steps = 2, 4
    key = jax.random.PRNGKey(len(mode))
    ctx = None if mode.startswith('uncond') else np.random.default_rng(
        5).standard_normal((b, 5, 48)).astype(np.float32)
    kw = dict(timesteps=steps, topk=3, temperature=1.0,
              trajectory='preds' if mode == 'cond-preds' else 'merged')
    if mode == 'guided-warmup':
        kw.update(guidance_scale=3.0, cfg_warmup=0.5)
    init = np.full((b, L), MASK, np.int32)
    jf, jt = jpl.generate_ids(jparams, key, jnp.asarray(init),
                              None if ctx is None else jnp.asarray(ctx),
                              cfg=J_PIPE, backend='xla', **kw)
    noise = torch.from_numpy(np.stack(_noise(key, steps, b)))
    tf, tt = tpl.generate_ids(tpipe, torch.from_numpy(init),
                              None if ctx is None else torch.from_numpy(ctx),
                              cfg=T_PIPE, noise=noise, **kw)
    assert tt.shape == (steps, b, L)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))


def test_inpaint_clamp_remask_bit_equal(jparams, tpipe):
    """The paint path: encode, mask a rect, 3 clamped steps with JAX's
    noise: ids bit-equal, the keep region preserved, decode within 1e-5."""
    img = _images(6, 2)
    keep = tpipe._rect_latent_mask((8, 8, 16, 16), inside=0)
    _, ids, _ = tpipe.to_latent(img)
    init = torch.where(keep.bool(), ids, torch.tensor(MASK, dtype=ids.dtype))
    key = jax.random.PRNGKey(8)
    jf, jt = jpl.generate_ids(jparams, key, jnp.asarray(_np(init)), None,
                              cfg=J_PIPE, backend='xla', timesteps=3, topk=2,
                              temperature=0.5, clamp_remask=True)
    noise = torch.from_numpy(np.stack(_noise(key, 3, 2)))
    tf, tt = tpl.generate_ids(tpipe, init, None, cfg=T_PIPE, timesteps=3,
                              topk=2, temperature=0.5, clamp_remask=True,
                              noise=noise)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    kept = _np(keep.bool().expand(2, L))
    np.testing.assert_array_equal(_np(tf)[kept], _np(ids)[kept])
    assert _mae(_np(tpipe.vqgan.decode_from_indice(tt[-1])),
                jvm.decode_from_indice(jparams['vqgan'], jt[-1],
                                       J_PIPE.vqc)) <= 1e-5


def test_remask_routes_agree_with_jax():
    """The rank route (L <= 2048) and the stable-sort route (L > 2048) of
    the re-mask give the same ids as the JAX rank route on tie-heavy
    scores, for scalar and per-sample counts."""
    rng = np.random.default_rng(3)
    b, l = 4, 24
    ids = rng.integers(0, 64, (b, l)).astype(np.int32)
    for _ in range(4):
        scores = np.round(rng.random((b, l)) * 4) / 4
        scores[rng.random((b, l)) > 0.6] = -1e5
        scores = scores.astype(np.float32)
        for n in (0, 1, l // 3, l, rng.integers(0, l, (b, 1)).astype(np.int32)):
            si, sj = scores[:, :, None], scores[:, None, :]
            idx = np.arange(l)
            rank = ((sj > si) | ((sj == si) & (idx[None, None, :]
                                              < idx[None, :, None]))).sum(-1)
            ref = np.where(rank < n, 999, ids)
            tn = torch.as_tensor(n)
            for route in (tpl._remask_by_rank, tpl._remask_by_sort):
                got = route(torch.from_numpy(scores), torch.from_numpy(ids),
                            tn, 999)
                np.testing.assert_array_equal(_np(got), ref)


def test_pipeline_object_api(tpipe):
    """generate (saved / final, guided with per-sample vectors,
    unconditional), sample, inpaint and outpaint run on the CPU, give
    images in [-1, 1], and keep the inpaint keep-region's tokens."""
    ctx = np.random.default_rng(0).standard_normal((2, 5, 48)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    imgs = tpipe.generate(text=ctx, timesteps=4, save_interval=2, topk=3,
                          generator=g)
    assert len(imgs) == 2 and imgs[0].shape == (2, 32, 32, 3)
    final = tpipe.generate(text=ctx, timesteps=3, topk=3, decode_steps='final',
                           guidance_scale=np.asarray([2.0, 3.0], np.float32),
                           temperature=np.asarray([0.5, 1.0], np.float32),
                           negative_text=ctx[:1], generator=g)
    assert len(final) == 1 and torch.isfinite(final[0]).all()
    assert final[0].abs().max() <= 1.0
    uncond = tpipe.generate(num_samples=3, timesteps=2, decode_steps='final')
    assert uncond[0].shape == (3, 32, 32, 3)
    ids_next, img = tpipe.sample(np.full((2, L), MASK, np.int32), 0.5,
                                 text=ctx, topk=2)
    assert (ids_next == MASK).sum(1).tolist() == [L // 2, L // 2]
    assert img.shape == (2, 32, 32, 3)
    x = _images(9, 2)
    assert tpipe.inpaint(x, (8, 8, 16, 16), text=ctx, timesteps=3).shape == \
        (2, 32, 32, 3)
    assert tpipe.outpaint(x, [(0, 0, 16, 16), (8, 8, 16, 16)],
                          timesteps=2).shape == (2, 32, 32, 3)
    with pytest.raises(ValueError, match='guidance_scale'):
        tpipe.generate(text=ctx, negative_text=ctx, timesteps=2)
    with pytest.raises(RuntimeError, match='text_encoder=None'):
        tpipe.generate(text=['a prompt'], timesteps=2)


def test_not_ported_branches_raise(tpipe):
    # every branch is ported: the multi-GPU placements refuse, as the JAX
    # package's do, a call without a mesh (the working paths are held in
    # tests/test_torch_parallel.py and test_torch_pipeline_parallel.py)
    with pytest.raises(ValueError, match='needs a mesh'):
        tpipe.enable_pipeline_parallel()
    with pytest.raises(ValueError, match='needs a mesh'):
        tpipe.shard()
    with pytest.raises(TypeError, match='parallel.mesh.Mesh'):
        tpipe.shard(object())
    # int8 is ported: a quantized copy (the fixture stays floating point)
    q = tpl.Pipeline(T_PIPE, stage1_pretrained=False, text_encoder=None,
                     device='cpu')
    q.load_state_dict(tpipe.state_dict())
    assert q.quantize('w8a8', min_dim=16) is q and q._quantized == 'w8a8'
    from paintmind_tpu_torch.nn.quant import QLinear
    qlinears = [m for m in q.modules() if isinstance(m, QLinear)]
    assert len(qlinears) == 2 * (4 + 4 + 2) + 1  # every block linear, head
    # int8 kernels replace the weights; each adds its (out,) scale
    assert q.num_params == tpipe.num_params + sum(m.out_features
                                                  for m in qlinears)
    with pytest.raises(ValueError, match='checkpoint_path'):
        pt.create_model('vqgan', 'vit-s-vqgan', device='cpu')


def test_entry_points_default_to_the_card():
    """Without device='cpu' a model is built on the card; with no card that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        m = pt.create_model('vqgan', 'torch-port-vqgan', pretrained=False)
        assert m.device.type == 'cuda'
        return
    for arch in ('vqgan', 'pipeline'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.create_model(arch, 'torch-port-vqgan' if arch == 'vqgan'
                            else 'paintmindv1', pretrained=False)


def test_import_hygiene():
    """The package (every module of it, the training, serving, tower, data,
    conversion and command-line ones included) and chip_smoke.py's import
    block load neither JAX, optax, orbax nor anything of paintmind_tpu;
    importing them builds no native library and imports none of the
    optional ``pandas``, ``datasets`` and ``lpips``."""
    code = (
        'import importlib, importlib.util, pkgutil, sys\n'
        'import paintmind_tpu_torch as pkg\n'
        'for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'spec = importlib.util.spec_from_file_location("chip_smoke", '
        '"chip_smoke.py")\n'
        'spec.loader.exec_module(importlib.util.module_from_spec(spec))\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "optax", "orbax", "paintmind_tpu")]\n'
        'need = ["paintmind_tpu_torch.utils.trainer", '
        '"paintmind_tpu_torch.train.steps", '
        '"paintmind_tpu_torch.optim.optimizers", '
        '"paintmind_tpu_torch.serving.engine", '
        '"paintmind_tpu_torch.serving.server", '
        '"paintmind_tpu_torch.serving.__main__", '
        '"paintmind_tpu_torch.models.t5", '
        '"paintmind_tpu_torch.models.clip", '
        '"paintmind_tpu_torch.scripts.train_vqgan", '
        '"paintmind_tpu_torch.scripts.train_paintmind", '
        '"paintmind_tpu_torch.scripts.generate", '
        '"paintmind_tpu_torch.scripts.convert_checkpoint", '
        '"paintmind_tpu_torch.utils.datasets", '
        '"paintmind_tpu_torch.utils.wds", '
        '"paintmind_tpu_torch.native.fastimage", '
        '"paintmind_tpu_torch.native.fastloader", '
        '"paintmind_tpu_torch.convert.torch_weights", '
        '"paintmind_tpu_torch.convert.resolution"]\n'
        'bad += [m for m in need if m not in sys.modules]\n'
        'bad += [m for m in ("pandas", "datasets", "lpips") if m in sys.modules]\n'
        'fi = sys.modules["paintmind_tpu_torch.native.fastimage"]\n'
        'bad += ["native library touched"] if (fi._lib, fi._error) != (None, None) else []\n'
        'print(len(sys.modules), bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_shipped_stage1_weights_match_jax():
    """vit_vq_photo.npz at full width, one 256² image, fp32 on the CPU:
    reconstruction within 1e-4 MAE of JAX; ids equal on >= 99.9 % of
    positions, and any mismatch is a near-tie (top-2 gap < 1e-5)."""
    cfg = jvm.VQModelConfig.from_dict(jcfg.ver2cfg['vit-s-vqgan'])
    template = jax.eval_shape(functools.partial(jvm.init_vqmodel, cfg=cfg),
                              jax.random.PRNGKey(0))
    params = jck.unflatten_like(template, jck.load_flat(ASSET))
    img = np.random.default_rng(11).uniform(-1, 1, (1, 256, 256, 3)).astype(
        np.float32)

    @jax.jit
    def run(p, x):
        z, _, ids = jvm.encode(p, x, cfg, backend='xla')
        return jvm.decode(p, z, cfg, backend='xla'), ids

    jrec, jids = run(params, jnp.asarray(img))
    model = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=ASSET,
                            device='cpu')
    z, _, ids = model.encode(img)
    rec = model.decode(z)
    ids, jids = _np(ids)[0], np.asarray(jids)[0]
    print(f'shipped stage-1 weights vs JAX: reconstruction MAE '
          f'{_mae(_np(rec), jrec):.3e}, ids equal {np.mean(ids == jids):.5f}')
    assert _mae(_np(rec), jrec) <= 1e-4
    assert np.mean(ids == jids) >= 0.999
    bad = np.nonzero(ids != jids)[0]
    if bad.size:
        with torch.no_grad():
            h = model.prev_quant(model.encoder(torch.from_numpy(img)))
            zn = pt.models.quantize.l2norm(h)[0, bad]
            e = pt.models.quantize.l2norm(model.quantize.codebook)
            s = zn @ e.t()
        gap = s[torch.arange(bad.size), torch.from_numpy(ids[bad]).long()] - \
            s[torch.arange(bad.size), torch.from_numpy(jids[bad]).long()]
        assert float(gap.abs().max()) < 1e-5


def test_reconstruction_demo_and_transform():
    """The stage-1 demo runs through the port (CPU here) and its right half
    is the model's reconstruction; the copied stage1_transform gives the
    JAX package's pixels."""
    from PIL import Image

    from paintmind_tpu.utils.transform import stage1_transform as jtf
    from paintmind_tpu_torch.reconstruct import restore
    from paintmind_tpu_torch.utils.transform import stage1_transform as ttf
    arr = np.random.default_rng(2).integers(0, 255, (300, 280, 3), np.uint8)
    img = Image.fromarray(arr, 'RGB')
    x = ttf(is_train=False)(img)
    np.testing.assert_array_equal(x, jtf(is_train=False)(img))
    model = pt.create_model('vqgan', 'vit-s-vqgan', pretrained=False,
                            device='cpu')
    fig = pt.reconstruction(img, model=model)
    assert fig.size == (512, 256)
    want = np.asarray(restore(model.reconstruct(x[None])[0]))
    got = np.asarray(fig)[:, 256:]
    assert np.abs(got[20:].astype(int) - want[20:].astype(int)).max() <= 1
