"""The port's command lines (``paintmind_tpu_torch.scripts``) on the CPU.

Each parser has the JAX script's options, with the same names, defaults,
types and choices, plus ``--device`` (default ``cuda``); the JAX side is
captured by stopping its ``parse_args``.  The four commands then run end to
end with ``--device cpu`` on a tiny registered version, chained as the smoke
run chains them on the card: ``train_vqgan`` from a folder of seeded JPEGs
(non-square ones included) and an initial checkpoint, ``train_paintmind``
over the tokenizer it exported, ``generate`` (prompted through a stand-in
tower, and ``--mode inpaint``) from the pipeline that exported, and
``convert_checkpoint``, whose archive must equal the JAX script's on the
same ``.pt``, key for key and bit for bit."""

import argparse
import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import vqmodel as jvm
from paintmind_tpu.utils import checkpoint as jck
import paintmind_tpu_torch as pt
from paintmind_tpu_torch.convert import torch_weights as ttw
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.scripts import (convert_checkpoint, generate,
                                         train_paintmind, train_vqgan)

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / 'scripts'
PORT = {'train_vqgan': train_vqgan, 'train_paintmind': train_paintmind,
        'generate': generate, 'convert_checkpoint': convert_checkpoint}

TINY_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
TINY_PIPE = {'stage1': 'torch-cli-vqgan', 't5': 't5-l', 'dim': 32,
             'dim_head': 16, 'mlp_dim': 64, 'num_head': 2, 'depth': 1,
             'dropout': 0.0}
for _reg in (jcfg, pt):
    _reg.register_version('torch-cli-vqgan', TINY_VQ)
    _reg.register_version('torch-cli-pipeline', TINY_PIPE)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(name, monkeypatch):
    """The JAX script's parser, captured when its ``main()`` parses."""
    spec = importlib.util.spec_from_file_location(f'jax_{name}',
                                                  SCRIPTS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def stop(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', stop)
    with pytest.raises(_Parsed) as caught:
        mod.main()
    monkeypatch.undo()
    return caught.value.parser, mod


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     tuple(a.choices) if a.choices else None, a.required,
                     type(a).__name__)
            for a in parser._actions if a.dest != 'help'}


@pytest.mark.parametrize('name', sorted(PORT))
def test_options_are_the_jax_scripts_plus_device(name, monkeypatch):
    jax_parser, _ = _jax_parser(name, monkeypatch)
    want = _options(jax_parser)
    got = _options(PORT[name].build_parser())
    device = got.pop('device')
    assert device[:2] == (('--device',), 'cuda')
    assert got == want


def _jpegs(folder, n=40):
    """Seeded JPEGs, every third one non-square (resize and crop)."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        h, w = (48, 72) if i % 3 == 0 else (40, 40)
        low = rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)
        img = Image.fromarray(low).resize((w, h), Image.BICUBIC)
        img.save(os.path.join(folder, f'img_{i:02d}.jpg'), quality=92)
    return folder


def _stand_in_tower(pipe):
    """A text tower: (B, 77, t5_dim) embeddings seeded by each prompt."""
    def embed(texts):
        return torch.stack([torch.from_numpy(np.random.default_rng(
            sum(map(ord, t))).standard_normal((77, pipe.config.t5_dim))
            .astype(np.float32)) for t in texts])
    return embed


def test_the_four_commands_chain_on_the_cpu(tmp_path, monkeypatch):
    """train_vqgan -> train_paintmind -> generate (prompted and inpaint) ->
    convert_checkpoint, each through ``main(argv)`` with ``--device cpu``:
    finite losses, exports at ``--save-every``, PNGs of the expected
    size, and the trainer's state file refused as a model checkpoint."""
    data = _jpegs(str(tmp_path / 'jpegs'))
    init = str(tmp_path / 'init.npz')
    pt.create_model('vqgan', 'torch-cli-vqgan', pretrained=False,
                    device='cpu', seed=3).save_pretrained(init)
    common = ['--batch-size', '2', '--grad-accum', '1', '--epochs', '1',
              '--sample-every', '1000', '--num-workers', '2',
              '--mixed-precision', 'no', '--device', 'cpu',
              '--log-dir', str(tmp_path / 'log')]
    s1 = train_vqgan.main([
        '--dataset', f'folder:{data}', '--version', 'torch-cli-vqgan',
        '--init-checkpoint', init, '--perceptual', 'none', '--save-every', '2',
        '--result-folder', str(tmp_path / 'vqgan'), '--ema-decay', '0.9',
        *common])
    # 40 images, 32 held out for validation (the trainer's default), batch 2
    assert s1.steps == 4
    assert np.isfinite(s1.log['rec loss']) and np.isfinite(s1.log['g loss'])
    models = tmp_path / 'vqgan' / 'models'
    assert sorted(os.listdir(models)) == [
        'vit_vq_state_2.pt', 'vit_vq_state_4.pt',
        'vit_vq_step_2.npz', 'vit_vq_step_4.npz']
    stage1 = str(models / 'vit_vq_step_4.npz')
    with pytest.raises(ValueError, match='resume'):  # a state is no checkpoint
        convert_checkpoint.main([str(models / 'vit_vq_state_4.pt'),
                                 str(tmp_path / 'state.npz')])

    s2 = train_paintmind.main([
        '--dataset', f'folder:{data}', '--version', 'torch-cli-pipeline',
        '--stage1-checkpoint', stage1, '--save-every', '3',
        '--valid-size', '30', '--optim', 'adamw',
        '--result-folder', str(tmp_path / 'paintmind'), *common])
    assert s2.steps == 5 and np.isfinite(s2.log['loss'])
    models = tmp_path / 'paintmind' / 'models'
    pipeline = str(models / 'paintmind_step_5.npz')
    assert sorted(os.listdir(models)) == [
        'paintmind_state_3.pt', 'paintmind_state_5.pt',
        'paintmind_step_3.npz', 'paintmind_step_5.npz']
    # the frozen tokenizer is the one stage 1 exported
    vq = pt.create_model('vqgan', 'torch-cli-vqgan', checkpoint_path=stage1,
                         device='cpu')
    assert torch.equal(s2.model.vqgan.quantize.codebook, vq.quantize.codebook)

    monkeypatch.setattr(tpl.Pipeline, '_get_text_model', _stand_in_tower)
    gen = ['--checkpoint', pipeline, '--version', 'torch-cli-pipeline',
           '--timesteps', '3', '--device', 'cpu']
    out = str(tmp_path / 'samples.png')
    imgs = generate.main([*gen, 'a red house', 'a boat', '--out', out,
                          '--guidance-scale', '3.0', '--negative', 'blur'])
    assert imgs.shape == (2, 32, 32, 3) and np.isfinite(imgs).all()
    assert Image.open(out).size == (2 * 32 + 3 * 2, 32 + 2 * 2)
    again = generate.main([*gen, 'a red house', 'a boat', '--out', out,
                           '--guidance-scale', '3.0', '--negative', 'blur'])
    np.testing.assert_array_equal(again, imgs)  # --seed fixes the samples
    out = str(tmp_path / 'inpaint.png')
    painted = generate.main([*gen, '--mode', 'inpaint', '--image',
                             os.path.join(data, 'img_00.jpg'),
                             '--rect', '8,8,16,16', '--out', out])
    assert painted.shape == (1, 32, 32, 3)
    assert Image.open(out).size == (36, 36)
    with pytest.raises(ValueError, match='resume'):
        generate.main(['--checkpoint',
                       str(models / 'paintmind_state_5.pt'),
                       '--version', 'torch-cli-pipeline', '--device', 'cpu'])

    # a seeded state dict in the reference's layout -> .npz
    pt_path = str(tmp_path / 'reference.pt')
    torch.save(ttw.to_reference(jvm.init_vqmodel(
        jax.random.PRNGKey(2), jvm.VQModelConfig.from_dict(TINY_VQ)),
        split_swiglu=True), pt_path)
    npz = convert_checkpoint.main([pt_path, str(tmp_path / 'c.npz')])
    loaded = pt.create_model('vqgan', 'torch-cli-vqgan', checkpoint_path=npz,
                             device='cpu')
    direct = pt.create_model('vqgan', 'torch-cli-vqgan',
                             checkpoint_path=pt_path, device='cpu')
    for (k, a), (_, b) in zip(loaded.state_dict().items(),
                              direct.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize('model', ['vqgan', 'pipeline'])
def test_convert_checkpoint_matches_the_jax_script(tmp_path, monkeypatch,
                                                   model):
    """The same reference ``.pt`` through both scripts: the same ``.npz``
    keys, bit-equal values; JAX's loader reads the port's archive."""
    from paintmind_tpu.models import pipeline as jpl
    cfg = jvm.VQModelConfig.from_dict(TINY_VQ)
    if model == 'vqgan':
        tree = jvm.init_vqmodel(jax.random.PRNGKey(5), cfg)
    else:
        tree = jpl.init_pipeline(jax.random.PRNGKey(5), jpl.PipelineConfig(
            vqc=cfg, **TINY_PIPE))
    # any file name torch.load reads, as the JAX script takes
    src = str(tmp_path / ('w.ckpt' if model == 'vqgan' else 'w.pt'))
    torch.save(ttw.to_reference(tree), src)
    mine, theirs = str(tmp_path / 'port.npz'), str(tmp_path / 'jax.npz')
    convert_checkpoint.main([src, mine, '--model', model])
    spec = importlib.util.spec_from_file_location(
        'jax_convert_checkpoint', SCRIPTS / 'convert_checkpoint.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, 'argv', ['convert_checkpoint.py', src, theirs,
                                      '--model', model])
    mod.main()
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jck.load_params(mine, template=tree)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('argv, item', [
    (['train_vqgan', '--device-cache'], 11),
    (['train_vqgan', '--eval-rfid'], 11),
    (['train_paintmind', '--device-cache'], 11),
])
def test_unported_flags_raise_with_their_item(argv, item):
    name, *flags = argv
    with pytest.raises(NotImplementedError,
                       match=rf'ROADMAP.md, queue A item {item}\)'):
        PORT[name].main(['--dataset', 'folder:/no/such/dir', *flags,
                         '--device', 'cpu'])


def test_refusals(tmp_path, monkeypatch):
    """``generate`` without ``--checkpoint`` raises the factory's
    downloads-nothing error; ``train_paintmind`` without a stage-1
    checkpoint the same; ``convert_checkpoint lpips`` says that the
    ``lpips`` package is missing; in/outpaint need ``--image``."""
    data = _jpegs(str(tmp_path / 'jpegs'), n=3)
    with pytest.raises(ValueError, match='downloads nothing'):
        generate.main(['--version', 'torch-cli-pipeline', '--device', 'cpu'])
    with pytest.raises(ValueError, match='downloads nothing'):
        train_paintmind.main(['--dataset', f'folder:{data}', '--version',
                              'torch-cli-pipeline', '--device', 'cpu'])
    monkeypatch.setitem(sys.modules, 'lpips', None)  # absent, whatever is installed
    with pytest.raises(SystemExit, match="'lpips' package"):
        convert_checkpoint.main(['lpips', str(tmp_path / 'lpips.npz')])
    npz = str(tmp_path / 'p.npz')
    pt.create_model('pipeline', 'torch-cli-pipeline', pretrained=False,
                    text_encoder=None, device='cpu').save_pretrained(npz)
    with pytest.raises(SystemExit, match='--image'):
        generate.main(['--checkpoint', npz, '--version', 'torch-cli-pipeline',
                       '--mode', 'outpaint', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='unknown dataset'):
        train_vqgan.main(['--dataset', 'laion:/x', '--device', 'cpu'])
