"""The port's conditioning towers held against the JAX package on the CPU.

T5 (``models/t5.py``) and the CLIP text and image towers
(``models/clip.py``) at small widths, on seeded random JAX trees carried
over by the weight bridge (``convert.from_jax.load_tower_params``): fp32 max
abs <= 1e-5.  The relative position buckets are equal; the image tower's
cubic resize matches ``jax.image.resize(..., 'cubic')`` within 1e-5 (JAX's
own result is some 2e-6 from an exact float64 resample); the HF / open_clip
converters agree with the JAX ones on the same state dicts; tower artifacts
round-trip between the two packages both ways.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paintmind_tpu.models import clip as jclip
from paintmind_tpu.models import t5 as jt5
from paintmind_tpu.utils.checkpoint import flatten_tree
from paintmind_tpu_torch.convert.from_jax import (load_tower_params,
                                                  tower_to_flat)
from paintmind_tpu_torch.models import clip as tclip
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import t5 as tt5

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

J_T5 = jt5.T5Config(vocab_size=100, d_model=64, d_kv=16, d_ff=96,
                    num_layers=2, num_heads=4, rel_buckets=16,
                    rel_max_distance=32)
T_T5 = tt5.T5Config(**dataclasses.asdict(J_T5))
TEXT_KW = dict(vocab_size=100, width=32, heads=2, layers=3)
# patch 7 over 28 pixels: 16 patches; the resize runs for any other size
VISION_KW = dict(image_size=28, patch_size=7, width=32, heads=2, layers=2)


def _max_abs(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a.astype(np.float64) - np.asarray(b, np.float64)).max())


def _ids(seed, b=2, n=77, vocab=100):
    ids = np.random.default_rng(seed).integers(1, vocab, (b, n))
    ids[:, n // 2:] = 0  # padding, attended as in the reference
    return ids


@pytest.fixture(scope='module')
def t5_pair():
    params = jt5.init_t5_encoder(jax.random.PRNGKey(0), J_T5)
    model = tt5.T5Encoder(T_T5, device='cpu')
    return params, load_tower_params(model, flatten_tree(params))


@pytest.fixture(scope='module')
def text_pair():
    params = jclip.init_clip_text(jax.random.PRNGKey(1),
                                  jclip.CLIPTextConfig(**TEXT_KW))
    model = tclip.CLIPTextTransformer(tclip.CLIPTextConfig(**TEXT_KW),
                                      device='cpu')
    return params, load_tower_params(model, flatten_tree(params))


@pytest.fixture(scope='module')
def vision_pair():
    params = jclip.init_clip_visual(jax.random.PRNGKey(2),
                                    jclip.CLIPVisionConfig(**VISION_KW))
    model = tclip.CLIPVisionTransformer(tclip.CLIPVisionConfig(**VISION_KW),
                                        device='cpu')
    return params, load_tower_params(model, flatten_tree(params))


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('buckets,distance', [(32, 128), (16, 32)])
def test_relative_position_bucket_matches_jax(buckets, distance):
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 301, 60)[:, None]
    got = tt5.relative_position_bucket(torch.from_numpy(rel), buckets, distance)
    want = jt5.relative_position_bucket(jnp.asarray(rel), buckets, distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t5_encoder_matches_jax(t5_pair):
    """2 layers, d_model 64, 77 tokens with padding: fp32 max abs <= 1e-5;
    the text encoder's contract (token ids, a tokenizer, a missing one)."""
    params, model = t5_pair
    ids = _ids(3)
    want = jt5.t5_encode(params, jnp.asarray(ids, jnp.int32), J_T5)
    got = model(torch.from_numpy(ids))
    assert got.shape == (2, 77, 64) and got.dtype == torch.float32
    assert _max_abs(got, want) <= 1e-5
    enc = tt5.T5TextEncoder(model=model, tokenizer=None, device='cpu')
    assert tt5.T5TextEmbedder is tt5.T5TextEncoder
    assert _max_abs(enc(ids), want) <= 1e-5
    with pytest.raises(RuntimeError, match='tokenizer'):
        enc(['hello world'])
    assert not any(p.requires_grad for p in enc.model.parameters())


def test_t5_bridge_round_trip(t5_pair):
    """Stacked ``blocks`` leaves go to blocks.<i> (kernels transposed) and
    come back bit for bit."""
    params, model = t5_pair
    flat = flatten_tree(params)
    np.testing.assert_array_equal(model.blocks[1].q.weight.detach().numpy(),
                                  np.asarray(params['blocks']['q'][1]).T)
    back = tower_to_flat(model)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
    bad = dict(flat, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match='unexpected'):
        load_tower_params(tt5.T5Encoder(T_T5, device='cpu'), bad)


def _hf_t5_state_dict(params):
    """A Hugging Face ``T5EncoderModel`` state dict with the JAX tree's
    values (the inverse of ``convert_t5_encoder``)."""
    sd = {'shared.weight': params['embed'],
          'encoder.final_layer_norm.weight': params['final_ln'],
          'encoder.block.0.layer.0.SelfAttention.relative_attention_bias.'
          'weight': params['rel_bias']}
    names = {'ln0': '0.layer_norm', 'q': '0.SelfAttention.q',
             'k': '0.SelfAttention.k', 'v': '0.SelfAttention.v',
             'o': '0.SelfAttention.o', 'ln1': '1.layer_norm',
             'wi_0': '1.DenseReluDense.wi_0', 'wi_1': '1.DenseReluDense.wi_1',
             'wo': '1.DenseReluDense.wo'}
    for i in range(J_T5.num_layers):
        for ours, theirs in names.items():
            w = np.asarray(params['blocks'][ours][i])
            sd[f'encoder.block.{i}.layer.{theirs}.weight'] = \
                torch.from_numpy(np.array(w if w.ndim == 1 else w.T))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_convert_t5_encoder_matches_jax(t5_pair):
    params, _ = t5_pair
    sd = _hf_t5_state_dict(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, jt5.convert_t5_encoder(sd))
    model = tt5.T5Encoder(T_T5, device='cpu')
    model.load_state_dict(tt5.convert_t5_encoder(sd))
    ids = _ids(4)
    assert _max_abs(model(torch.from_numpy(ids)),
                    jt5.t5_encode(jparams, jnp.asarray(ids, jnp.int32),
                                  J_T5)) <= 1e-5


def test_t5_text_encoder_without_transformers(monkeypatch):
    """Loading weights by name needs ``transformers``; without it the error
    says what to pass instead."""
    monkeypatch.setitem(sys.modules, 'transformers', None)
    with pytest.raises(RuntimeError, match="'transformers'"):
        tt5.T5TextEncoder('some/local/dir', device='cpu')


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('layer', ['last', 'penultimate'])
def test_clip_text_matches_jax(text_pair, layer):
    """Causal, 3 layers, width 32: fp32 max abs <= 1e-5 for both layers;
    the embedder takes ids, refuses text without a tokenizer."""
    params, model = text_pair
    ids = _ids(5)
    want = jclip.clip_text_encode(params, jnp.asarray(ids, jnp.int32),
                                  jclip.CLIPTextConfig(**TEXT_KW), layer=layer)
    assert _max_abs(model(torch.from_numpy(ids), layer), want) <= 1e-5
    emb = tclip.CLIPTextEmbedder(model, cfg=model.cfg, layer=layer,
                                 device='cpu')
    assert _max_abs(emb(ids), want) <= 1e-5
    with pytest.raises(RuntimeError, match='tokenizer'):
        emb(['a prompt'])


@pytest.mark.parametrize('size', [28, 32, 24, 59])
def test_clip_image_tower_matches_jax(vision_pair, size):
    """The image tower at its own size and with the resize (down 32, 59;
    up 24): fp32 max abs <= 1e-5 (measured 5e-6 to 7e-6 with resize, on
    outputs up to about 8)."""
    params, model = vision_pair
    img = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(
        np.float32)
    want = jclip.clip_image_encode(params, jnp.asarray(img),
                                   jclip.CLIPVisionConfig(**VISION_KW))
    got = model(torch.from_numpy(img))
    assert got.shape == (2, 16, 32)
    assert _max_abs(got, want) <= 1e-5
    emb = tclip.CLIPImageEmbedder(model, cfg=model.cfg, device='cpu')
    assert _max_abs(emb(img), want) <= 1e-5


@pytest.mark.parametrize('src,dst', [(256, 224), (200, 224)])
def test_cubic_resize_matches_jax(src, dst):
    """Keys cubic a = -0.5, antialiased when downsampling: within 1e-5 of
    ``jax.image.resize(..., 'cubic')`` (measured 2e-6); not torch's bicubic,
    which is farther."""
    x = np.random.default_rng(src).uniform(-1, 1, (2, src, src, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3),
                                       'cubic'))
    got = tclip.resize_cubic(torch.from_numpy(x), dst)
    assert got.shape == (2, dst, dst, 3)
    assert _max_abs(got, want) <= 1e-5
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst),
        mode='bicubic', align_corners=False).permute(0, 2, 3, 1)
    assert _max_abs(bicubic, want) > 1e-3


def _open_clip_state_dict(params, prefix=''):
    """An open_clip state dict with the JAX tree's values (the inverse of
    ``convert_clip_text`` / ``convert_clip_visual``)."""
    sd = {}
    for i, p in enumerate(params['resblocks']):
        pre = f'{prefix}transformer.resblocks.{i}.'
        for ln in ('ln_1', 'ln_2'):
            sd[pre + ln + '.weight'] = p[ln]['scale']
            sd[pre + ln + '.bias'] = p[ln]['bias']
        sd[pre + 'attn.in_proj_weight'] = p['attn']['in_proj_w'].T
        sd[pre + 'attn.in_proj_bias'] = p['attn']['in_proj_b']
        sd[pre + 'attn.out_proj.weight'] = p['attn']['out_proj_w'].T
        sd[pre + 'attn.out_proj.bias'] = p['attn']['out_proj_b']
        sd[pre + 'mlp.c_fc.weight'] = p['mlp_fc_w'].T
        sd[pre + 'mlp.c_fc.bias'] = p['mlp_fc_b']
        sd[pre + 'mlp.c_proj.weight'] = p['mlp_proj_w'].T
        sd[pre + 'mlp.c_proj.bias'] = p['mlp_proj_b']
    if 'conv1' in params:
        width, patch = VISION_KW['width'], VISION_KW['patch_size']
        conv = np.asarray(params['conv1']).reshape(patch, patch, 3, width)
        sd[prefix + 'conv1.weight'] = conv.transpose(3, 2, 0, 1)
        for name in ('class_embedding', 'positional_embedding'):
            sd[prefix + name] = params[name]
        sd[prefix + 'ln_pre.weight'] = params['ln_pre']['scale']
        sd[prefix + 'ln_pre.bias'] = params['ln_pre']['bias']
    else:
        sd['token_embedding.weight'] = params['token_embedding']
        sd['positional_embedding'] = params['positional_embedding']
        sd['ln_final.weight'] = params['ln_final']['scale']
        sd['ln_final.bias'] = params['ln_final']['bias']
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_convert_clip_matches_jax(text_pair, vision_pair):
    """open_clip state dicts through the JAX and the port's converters give
    the same towers (fp32 max abs <= 1e-5), the patch convolution included."""
    tparams, _ = text_pair
    sd = _open_clip_state_dict(tparams)
    jp = jax.tree_util.tree_map(jnp.asarray, jclip.convert_clip_text(sd))
    text = tclip.CLIPTextTransformer(tclip.CLIPTextConfig(**TEXT_KW),
                                     device='cpu')
    text.load_state_dict(tclip.convert_clip_text(sd))
    ids = _ids(6)
    assert _max_abs(text(torch.from_numpy(ids)), jclip.clip_text_encode(
        jp, jnp.asarray(ids, jnp.int32), jclip.CLIPTextConfig(**TEXT_KW))) <= 1e-5
    vparams, _ = vision_pair
    sd = _open_clip_state_dict(vparams, prefix='visual.')
    jp = jax.tree_util.tree_map(jnp.asarray, jclip.convert_clip_visual(sd))
    vision = tclip.CLIPVisionTransformer(tclip.CLIPVisionConfig(**VISION_KW),
                                         device='cpu')
    vision.load_state_dict(tclip.convert_clip_visual(sd))
    img = np.random.default_rng(7).uniform(-1, 1, (1, 28, 28, 3)).astype(
        np.float32)
    assert _max_abs(vision(torch.from_numpy(img)), jclip.clip_image_encode(
        jp, jnp.asarray(img), jclip.CLIPVisionConfig(**VISION_KW))) <= 1e-5


def test_image_tower_artifacts_round_trip(tmp_path):
    """``save_image_tower`` of either package loads in the other's
    ``load_image_tower``, head count included (4 heads of width 32: not the
    width // 64 convention), with the same outputs (fp32 max abs <= 1e-5)."""
    cfg = dict(VISION_KW, heads=4)
    jtower = jclip.CLIPImageEmbedder(cfg=jclip.CLIPVisionConfig(**cfg), seed=3)
    img = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = jtower(jnp.asarray(img))
    jclip.save_image_tower(str(tmp_path / 'jax.npz'), jtower)
    tower = tclip.load_image_tower(str(tmp_path / 'jax.npz'), device='cpu')
    assert tower.cfg == tclip.CLIPVisionConfig(**cfg)
    assert _max_abs(tower(img), want) <= 1e-5
    tclip.save_image_tower(str(tmp_path / 'torch.npz'), tower)
    back = jclip.load_image_tower(str(tmp_path / 'torch.npz'))
    assert back.cfg == jclip.CLIPVisionConfig(**cfg)
    assert _max_abs(back(jnp.asarray(img)), want) <= 1e-5
    bf16 = tclip.load_image_tower(str(tmp_path / 'jax.npz'),
                                  dtype=torch.bfloat16, device='cpu')
    assert bf16(img).dtype == torch.bfloat16
    with pytest.raises(ValueError, match='resblocks'):
        np.savez(tmp_path / 'empty.npz', conv1=np.zeros((3, 4)))
        tclip.load_image_tower(str(tmp_path / 'empty.npz'), device='cpu')


# ---------------------------------------------------------------------------
# towers in the pipeline
# ---------------------------------------------------------------------------

def _pipe(t5, t5_dim, tower):
    from paintmind_tpu_torch import config as tcfg
    small = {
        'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
        'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
                'num_head': 2, 'mlp_dim': 64, 'in_channels': 3,
                'dim_head': 16, 'dropout': 0.0},
        'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
                'num_head': 2, 'mlp_dim': 64, 'out_channels': 3,
                'dim_head': 16, 'dropout': 0.0}}
    tcfg.register_version('torch-tower-vqgan', small)
    cfg = tpl.PipelineConfig(stage1='torch-tower-vqgan', t5=t5, dim=32,
                             dim_head=16, mlp_dim=64, num_head=2, depth=1,
                             dropout=0.0, t5_dim=t5_dim,
                             vqc=tpl.vm.VQModelConfig.from_dict(small))
    return tpl.Pipeline(cfg, stage1_pretrained=False, text_encoder=tower,
                        device='cpu')


def _tokenizer(texts, truncation, max_length, padding, return_tensors):
    """A deterministic stand-in: word lengths as ids, padded with 0."""
    ids = np.zeros((len(texts), max_length), np.int64)
    for i, t in enumerate(texts):
        words = [len(w) % 99 + 1 for w in t.split()][:max_length]
        ids[i, :len(words)] = words
    return {'input_ids': ids}


def test_pipeline_embeds_through_its_towers(t5_pair, text_pair, vision_pair):
    """``embed_text`` takes prompts and ids through a T5 tower (equal to the
    JAX pipeline's own ``embed_text``), ids through a CLIP text tower,
    images through an image tower, and passes contexts through; the tower
    stays out of the parameter tree."""
    from paintmind_tpu.models import pipeline as jpl
    params, model = t5_pair
    tower = tt5.T5TextEncoder(model=model, tokenizer=_tokenizer, device='cpu')
    pipe = _pipe('t5-l', 64, tower)
    prompts = ['a red fox', 'two cats on a mat']
    jtower = jt5.T5TextEncoder(params=params, cfg=J_T5, tokenizer=_tokenizer)
    want = jpl.Pipeline.embed_text(
        type('P', (), {'_get_text_model': lambda self: jtower})(), prompts)
    got = pipe.embed_text(prompts)
    assert got.shape == (2, 77, 64) and _max_abs(got, want) <= 1e-5
    ids = _tokenizer(prompts, True, 77, 'max_length', 'np')['input_ids']
    assert torch.equal(pipe.embed_text(ids), got)
    ctx = np.ones((2, 5, 64))
    assert pipe.embed_text(ctx).dtype == torch.float32
    assert not any(k.startswith('text') for k in pipe.state_dict())
    with pytest.raises(ValueError, match='contexts'):
        pipe.embed_text(np.zeros((2, 3, 4, 5, 6), np.float32))
    out = pipe.generate(text=prompts, timesteps=2, topk=2, decode_steps='final')
    assert out[-1].shape == (2, 32, 32, 3)

    tparams, text = text_pair
    clip_pipe = _pipe('clip-l', 32, tclip.CLIPTextEmbedder(
        text, cfg=text.cfg, device='cpu'))
    ids = _ids(9)
    assert _max_abs(clip_pipe.embed_text(ids), jclip.clip_text_encode(
        tparams, jnp.asarray(ids, jnp.int32),
        jclip.CLIPTextConfig(**TEXT_KW))) <= 1e-5

    vparams, vision = vision_pair
    img_pipe = _pipe('clip-img-l', 32, tclip.CLIPImageEmbedder(
        vision, cfg=vision.cfg, device='cpu'))
    img = np.random.default_rng(10).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    assert _max_abs(img_pipe.embed_text(img), jclip.clip_image_encode(
        vparams, jnp.asarray(img), jclip.CLIPVisionConfig(**VISION_KW))) <= 1e-5


def test_pipeline_tower_policy():
    """'auto' refuses a CLIP tower (no trained weights offline) and
    text_encoder=None refuses text; both pipelines still build."""
    auto = _pipe('clip-img-l', 32, 'auto')
    with pytest.raises(RuntimeError, match='no pretrained CLIP'):
        auto.embed_text(np.zeros((1, 32, 32, 3), np.float32))
    off = _pipe('t5-l', 64, None)
    with pytest.raises(RuntimeError, match='text_encoder=None'):
        off.embed_text(['a prompt'])
    assert off.embed_text(None) is None


def test_factory_builds_tower_versions():
    """``paintmindv1-imgvar`` at full width takes its image tower through
    ``text_encoder=``."""
    import paintmind_tpu_torch as pt
    tower = tclip.CLIPImageEmbedder(cfg=tclip.CLIPVisionConfig(**VISION_KW),
                                    device='cpu')
    pipe = pt.create_model('pipeline', 'paintmindv1-imgvar', pretrained=False,
                           text_encoder=tower, device='cpu')
    assert pipe.text_model is tower and pipe.config.t5_dim == 1024
