"""Reference ``.pt`` weights and resolution adaptation, the port against the
JAX package on the CPU.

The test trees are JAX inits from seeds, written into the reference's
state-dict layout by the port's inverse (``convert.torch_weights.
to_reference``), which is proven first: JAX's ``convert_*`` must give the
seeded tree back, bit for bit, with the feed-forward packed (``w12``) or
split (``w1`` / ``w2``).  Then the same ``.pt`` file loads into both
packages: encode ids equal, ``encode`` / ``decode`` /
``_transformer_logits`` within 1e-5 max abs (fp32).  Resolution:
``interpolate_pos_embed`` within 1e-6 max abs of ``jax.image.resize``;
``generate_ids`` at L = 4096 (the 512² token count, the re-mask's sort
route) bit-equal on JAX's noise."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.convert import resolution as jres
from paintmind_tpu.convert import torch_weights as jtw
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.utils import checkpoint as jck
import paintmind_tpu_torch as pt
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.convert import resolution as tres
from paintmind_tpu_torch.convert import torch_weights as ttw
from paintmind_tpu_torch.convert.from_jax import flatten_tree, load_jax_params
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.utils.checkpoint import load_flat

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, 'paintmind_tpu', 'assets', 'vit_vq_photo.npz')


def _vq(image_size, depth=2):
    vit = {'image_size': image_size, 'patch_size': 8, 'dim': 32,
           'depth': depth, 'num_head': 2, 'mlp_dim': 64, 'dim_head': 16,
           'dropout': 0.0}
    return {'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
            'enc': {**vit, 'in_channels': 3},
            'dec': {**vit, 'out_channels': 3}}


SMALL_VQ = _vq(32)
for _reg in (jcfg, tcfg):
    _reg.register_version('torch-convert-vqgan', SMALL_VQ)
PIPE_KW = dict(stage1='torch-convert-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, depth=2, dropout=0.0, t5_dim=48)
J_PIPE = jpl.PipelineConfig(vqc=jvm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)
T_PIPE = tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)


def _np(t):
    return t.detach().cpu().numpy()


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _images(seed, b, size=32):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def jvq_params():
    return jvm.init_vqmodel(jax.random.PRNGKey(3), J_PIPE.vqc)


@pytest.fixture(scope='module')
def jpipe_params():
    return jpl.init_pipeline(jax.random.PRNGKey(4), J_PIPE)


def _assert_trees_equal(got, want):
    """Two trees (nested JAX / numpy or flat torch), key for key, bit for bit."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


@pytest.mark.parametrize('model', ['vqgan', 'pipeline'])
@pytest.mark.parametrize('split', [False, True])
def test_inverse_mapping_is_proven_by_jax(jvq_params, jpipe_params, model,
                                          split):
    """JAX tree -> reference layout (the port's inverse) -> JAX's
    ``convert_*`` gives the tree back, bit for bit; the port's own
    ``convert_*`` gives the same tree."""
    tree = jvq_params if model == 'vqgan' else jpipe_params
    sd = ttw.to_reference(tree, split_swiglu=split)
    assert ('encoder.transformer.layers.1.ffnet.w1.weight' in
            {k[len('vqgan.'):] if k.startswith('vqgan.') else k
             for k in sd}) == split
    if model == 'pipeline':
        assert 'transformer.layers.layer1.attn2.to_out.0.weight' in sd
        assert 'transformer.context_proj.weight' in sd
    convert = {'vqgan': jtw.convert_vqmodel,
               'pipeline': jtw.convert_pipeline}[model]
    _assert_trees_equal(convert(sd), tree)
    _assert_trees_equal(ttw.CONVERTERS[model](sd), tree)


def _save_reference(tmp_path, tree, split, name):
    path = str(tmp_path / name)
    torch.save(ttw.to_reference(tree, split_swiglu=split), path)
    return path


@pytest.mark.parametrize('split', [False, True])
def test_vqmodel_from_reference_pt_matches_jax(tmp_path, jvq_params, split):
    """``VQModel.from_pretrained('x.pt')`` (and the factory's
    ``checkpoint_path``) against JAX's ``load_params`` of the same file:
    ids equal, z_q and decode within 1e-5 max abs."""
    path = _save_reference(tmp_path, jvq_params, split, 'vqgan.pt')
    jp = jck.load_params(path, template=jvq_params, model='vqgan')
    vq = pt.create_model('vqgan', 'torch-convert-vqgan', pretrained=True,
                         checkpoint_path=path, device='cpu')
    img = _images(1, 3)
    jz, _, jids = jvm.encode(jp, jnp.asarray(img), J_PIPE.vqc, backend='xla')
    z, _, ids = vq.encode(img)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    assert _maxabs(_np(z), jz) <= 1e-5
    assert _maxabs(_np(vq.decode(z)), jvm.decode(jp, jz, J_PIPE.vqc)) <= 1e-5
    for suffix in ('.pth', '.bin'):
        other = path[:-3] + suffix
        os.replace(path, other)
        vq2 = tvm.VQModel(tcfg.Config(SMALL_VQ), seed=9, device='cpu')
        assert torch.equal(vq2.from_pretrained(other).quantize.codebook,
                           vq.quantize.codebook)
        path = other


@pytest.mark.parametrize('split', [False, True])
def test_pipeline_from_reference_pt_matches_jax(tmp_path, jpipe_params, split):
    """``Pipeline.from_pretrained('x.pt')``: the guided transformer logits
    and the stage-1 decode within 1e-5 max abs of JAX on the same file."""
    sd = ttw.to_reference(jpipe_params, split_swiglu=split)
    sd['t5.encoder.weight'] = torch.zeros(3)  # a text tower's keys are skipped
    path = str(tmp_path / 'pipeline.pt')
    torch.save(sd, path)
    jp = jck.load_params(path, template=jpipe_params, model='pipeline')
    pipe = tpl.Pipeline(T_PIPE, stage1_pretrained=False, text_encoder=None,
                        device='cpu').from_pretrained(path)
    rng = np.random.default_rng(2)
    tokens = rng.standard_normal((2, J_PIPE.num_tokens, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 48)).astype(np.float32)
    want = jpl._transformer_logits(jp, jnp.asarray(tokens), jnp.asarray(ctx),
                                   3.0, cfg=J_PIPE, backend='xla')
    got = tpl._transformer_logits(pipe, torch.from_numpy(tokens),
                                  torch.from_numpy(ctx), 3.0, cfg=T_PIPE)
    assert _maxabs(_np(got), want) <= 1e-5
    ids = rng.integers(0, 64, (2, J_PIPE.num_tokens)).astype(np.int32)
    assert _maxabs(_np(pipe.vqgan.decode_from_indice(ids)),
                   jvm.decode_from_indice(jp['vqgan'], jnp.asarray(ids),
                                          J_PIPE.vqc)) <= 1e-5


def test_shipped_weights_as_a_full_width_pt(tmp_path):
    """The shipped ``vit_vq_photo.npz`` written out as a full-width
    reference ``.pt``: the port loads every parameter bit-equal to the
    ``.npz`` load, so one 256² image encodes to the same ids and codes."""
    flat = load_flat(ASSET)
    path = str(tmp_path / 'vit-s-vqgan.pt')
    torch.save(ttw.to_reference(flat), path)
    a = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=ASSET,
                        device='cpu')
    b = pt.create_model('vqgan', 'vit-s-vqgan', checkpoint_path=path,
                        device='cpu')
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    img = _images(5, 1, 256)
    za, _, ia = a.encode(img)
    zb, _, ib = b.encode(img)
    assert torch.equal(ia, ib) and torch.equal(za, zb)


def test_trainer_state_file_is_refused(tmp_path, jvq_params):
    """A trainer's state file is not a model checkpoint: by its name
    (``*_state_N.pt``) or by its content (``model`` and ``step``) it is
    refused with an error that names ``resume()``."""
    state = {'model': ttw.to_reference(jvq_params), 'step': 4,
             'generator': torch.zeros(8, dtype=torch.uint8)}
    for name in ('vit_vq_state_4.pt', 'renamed.pt'):
        path = str(tmp_path / name)
        torch.save(state, path)
        with pytest.raises(ValueError, match=r'resume\(\)|resume\(path\)'):
            tvm.VQModel(tcfg.Config(SMALL_VQ), device='cpu').from_pretrained(path)
    with pytest.raises(ValueError, match='resume'):
        load_flat(str(tmp_path / 'paintmind_state_12.pt'), 'pipeline')
    with pytest.raises(ValueError, match="model 'vqgan'"):
        load_flat(str(tmp_path / 'renamed.pt'.replace('renamed', 'x')))


def test_lpips_conversion_layout():
    """``convert_lpips`` on a state dict in the ``lpips`` package's layout
    gives the JAX package's LPIPS tree, which the port's LPIPS loads."""
    from paintmind_tpu.models import lpips as jlp
    from paintmind_tpu_torch.convert.from_jax import load_lpips_params
    from paintmind_tpu_torch.models import lpips as tlp
    g = torch.Generator().manual_seed(0)
    # lpips' VGG slices keep torchvision's indices into vgg16().features
    convs = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21),
             5: (24, 26, 28)}
    widths = iter(c for c in tlp.VGG16_CFG if c != 'M')
    sd, cin = {}, 3
    for s, indices in convs.items():
        for i in indices:
            c = next(widths)
            sd[f'net.slice{s}.{i}.weight'] = torch.randn(c, cin, 3, 3,
                                                         generator=g)
            sd[f'net.slice{s}.{i}.bias'] = torch.randn(c, generator=g)
            cin = c
    for i, c in enumerate(tlp.TAP_CHANNELS):
        sd[f'lin{i}.model.1.weight'] = torch.rand(1, c, 1, 1, generator=g)

    class Module:
        def state_dict(self):
            return sd

    want = jlp.convert_lpips(Module())
    got = tlp.convert_lpips(Module())
    _assert_trees_equal(got, want)
    module = load_lpips_params(tlp.LPIPS(device='cpu'), flatten_tree(got))
    assert torch.equal(module.lins[2], sd['lin2.model.1.weight'][0, :, 0, 0])


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('grids', [(32, 64), (8, 16), (16, 8)])
def test_interpolate_pos_embed_matches_jax(grids):
    g, ng = grids
    pos = np.random.default_rng(g).standard_normal((1, g * g, 24)).astype(
        np.float32)
    want = np.asarray(jres.interpolate_pos_embed(jnp.asarray(pos), ng * ng))
    got = tres.interpolate_pos_embed(torch.from_numpy(pos), ng * ng)
    assert got.shape == want.shape == (1, ng * ng, 24)
    assert _maxabs(_np(got), want) <= 1e-6
    assert tres.interpolate_pos_embed(torch.from_numpy(pos), g * g) is not None
    with pytest.raises(ValueError, match='square'):
        tres.interpolate_pos_embed(torch.from_numpy(pos), 10)


def test_adapt_resolution_matches_jax(jvq_params, jpipe_params):
    """``adapt_vqmodel_resolution`` / ``adapt_pipeline_resolution`` give
    JAX's trees key for key (pos-embeds within 1e-6, the rest bit-equal),
    and the result loads into the larger registered variant."""
    new = 64  # 4² -> 8² patches
    for jfn, tfn, tree in ((jres.adapt_vqmodel_resolution,
                            tres.adapt_vqmodel_resolution, jvq_params),
                           (jres.adapt_pipeline_resolution,
                            tres.adapt_pipeline_resolution, jpipe_params)):
        want = flatten_tree(jfn(tree, new))
        got = tfn(flatten_tree(tree), new)
        assert sorted(got) == sorted(want)
        for k in want:
            tol = 1e-6 if k.endswith('pos_embed') else 0.0
            assert got[k].shape == want[k].shape, k
            assert _maxabs(_np(got[k]), _np(want[k])) <= tol, k
    big = _vq(64)
    tcfg.register_version('torch-convert-vqgan-64', big)
    pipe = tpl.Pipeline(tpl.PipelineConfig(
        vqc=tvm.VQModelConfig.from_dict(big),
        **{**PIPE_KW, 'stage1': 'torch-convert-vqgan-64'}),
        stage1_pretrained=False, text_encoder=None, device='cpu')
    load_jax_params(pipe, got)  # the adapted pipeline tree
    assert pipe.transformer.pos_embed.shape == (1, new, 32)


def test_generate_ids_at_4096_tokens_bit_equal():
    """A tiny transformer over a 512² tokenizer (L = 4096 tokens), two
    steps on JAX's Gumbel noise: final ids and trajectory bit-equal to
    JAX's sort route, and the port took its sort route."""
    vq512 = _vq(512, depth=1)
    tcfg.register_version('torch-convert-vqgan-512', vq512)
    kw = {**PIPE_KW, 'depth': 1, 'stage1': 'torch-convert-vqgan-512'}
    jc = jpl.PipelineConfig(vqc=jvm.VQModelConfig.from_dict(vq512), **kw)
    tc = tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(vq512), **kw)
    assert jc.num_tokens == 4096
    jparams = jpl.init_pipeline(jax.random.PRNGKey(6), jc)
    pipe = load_jax_params(
        tpl.Pipeline(tc, stage1_pretrained=False, text_encoder=None,
                     device='cpu'), flatten_tree(jparams))
    b, steps, l, v = 2, 2, jc.num_tokens, jc.vqc.n_embed
    key = jax.random.PRNGKey(7)
    ctx = np.random.default_rng(8).standard_normal((b, 5, 48)).astype(
        np.float32)
    init = np.full((b, l), jc.mask_token_id, np.int32)
    jf, jt = jpl.generate_ids(jparams, key, jnp.asarray(init),
                              jnp.asarray(ctx), cfg=jc, backend='xla',
                              timesteps=steps, topk=3, temperature=1.0)
    noise = torch.from_numpy(np.stack(
        [np.array(jpl._gumbel(k, (b, l, v)))
         for k in jax.random.split(key, steps)]))
    before = tpl.sort_remasks
    tf, tt = tpl.generate_ids(pipe, torch.from_numpy(init),
                              torch.from_numpy(ctx), cfg=tc, noise=noise,
                              timesteps=steps, topk=3, temperature=1.0)
    assert tpl.sort_remasks - before == steps
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    # the schedule's last step re-masks max(0·L, 1) = 1 token per row
    assert (tf == jc.mask_token_id).sum(1).tolist() == [1, 1]
