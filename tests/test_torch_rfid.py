"""The port's rFID tier (``paintmind_tpu_torch/models/inception.py``,
``utils/metrics.py``, ``VQGANTrainer(eval_rfid=True)``) held against the
JAX package on the CPU.

Tolerances: pool3 features within 1e-4 relative to the largest feature
(fp32 convolutions summed in another order); ``convert_inception`` equal
key for key and bit for bit; ``frechet_distance`` and ``fid`` within 1e-6
relative (the same float64 numpy and scipy on equal inputs); ``rfid`` from
one weights file within 1e-3 relative (the features' fp32 differences
through a square root of a rank-deficient covariance product).  The
random-feature extractor ('rfid-rand') draws with torch, so its values are
compared within the port only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import inception as jinc
from paintmind_tpu.utils import checkpoint as jck
from paintmind_tpu.utils import metrics as jmetrics
from paintmind_tpu.utils.checkpoint import flatten_tree
import paintmind_tpu_torch as pt
from paintmind_tpu_torch.convert.from_jax import load_inception_params
from paintmind_tpu_torch.models import inception as tinc
from paintmind_tpu_torch.utils import metrics as tmetrics

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

TINY_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
for _reg in (jcfg, pt):
    _reg.register_version('torch-rfid-vqgan', TINY_VQ)


@pytest.fixture(scope='module')
def jtree():
    # jitted: op by op the init dispatches each of its ~470 draws
    return jax.jit(jinc.init_inception)(jax.random.PRNGKey(0))


def _images(seed, b, size):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)) \
        .astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('size', [48, 320], ids=['up', 'down'])
def test_pool3_features_match_jax(jtree, size):
    """Full-width pool3 on JAX's ``init_inception`` tree carried across by
    the bridge: within 1e-4 relative, from images that the bilinear
    preprocess enlarges (48²) and shrinks with its antialiased kernel
    (320²)."""
    net = load_inception_params(tinc.InceptionV3(device='cpu'),
                                flatten_tree(jtree))
    x = _images(1, 2, size)
    want = np.asarray(jinc.pool3_features(jtree, jnp.asarray(x)))
    got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, tinc.POOL3_DIM) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-4
    # the 299² input within 1e-4 absolute (ImageNet-normalized, |x| < 2.7):
    # XLA's CPU contraction of the shrink is 1.25e-5 off the float64 product
    # of the same weights on [0, 1] pixels, the port's 1e-7
    pre = tinc.preprocess(torch.from_numpy(x)).numpy()
    assert np.abs(pre - np.asarray(jinc.preprocess(jnp.asarray(x)))).max() \
        <= 1e-4


def _torchvision_state_dict(rng):
    """A seeded state dict in torchvision's ``Inception3`` layout, with the
    aux-logits and fc entries the converter ignores."""
    sd = {'fc.weight': rng.standard_normal((1000, 2048)).astype(np.float32),
          'AuxLogits.conv0.conv.weight': np.zeros((128, 768, 1, 1),
                                                  np.float32)}
    for name, spec in tinc._LAYOUT:
        convs = {name: spec} if isinstance(spec, tuple) else {
            f'{name}.{b}': dims for b, dims in spec.items()}
        for prefix, (cin, cout, kh, kw) in convs.items():
            sd[f'{prefix}.conv.weight'] = (rng.standard_normal(
                (cout, cin, kh, kw)) * np.sqrt(2.0 / (kh * kw * cin))
            ).astype(np.float32)
            sd[f'{prefix}.bn.weight'] = rng.uniform(0.5, 1.5, cout).astype(
                np.float32)
            sd[f'{prefix}.bn.bias'] = rng.normal(0, 0.1, cout).astype(
                np.float32)
            sd[f'{prefix}.bn.running_mean'] = rng.normal(0, 0.1, cout).astype(
                np.float32)
            sd[f'{prefix}.bn.running_var'] = rng.uniform(0.5, 2.0, cout) \
                .astype(np.float32)
    return sd


def test_convert_inception_and_rfid_from_weights_match_jax(tmp_path):
    """``convert_inception`` of a seeded torchvision-layout state dict
    (numpy, and torch tensors) equals JAX's; saved as ``.npz`` by the JAX
    package, ``rfid(weights=path)`` gives JAX's value within 1e-3 relative
    and the same variant; ``load_inception`` loads the file."""
    sd = _torchvision_state_dict(np.random.default_rng(2))
    want = flatten_tree(jinc.convert_inception(sd))
    for src in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = flatten_tree(tinc.convert_inception(src))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = str(tmp_path / 'inception_v3.npz')
    jck.save_params(path, jinc.convert_inception(sd))
    net = tinc.load_inception(path, device='cpu')
    assert torch.equal(net.Mixed_7c.branch_pool.weight,
                       torch.from_numpy(sd['Mixed_7c.branch_pool.conv.weight']))
    real = _images(3, 12, 40)
    fake = np.clip(real + np.random.default_rng(4).normal(
        0, 0.2, real.shape), -1, 1).astype(np.float32)
    jv, jvar = jmetrics.rfid(real, fake, weights=path, batch=8)
    tv, tvar = tmetrics.rfid(real, fake, weights=path, batch=8, device='cpu')
    assert tvar == jvar == 'rfid-inception'
    assert abs(tv - jv) <= 1e-3 * abs(jv), (tv, jv)


def test_frechet_distance_and_fid_match_jax():
    """The float64 statistics and the Fréchet distance within 1e-6
    relative of JAX's, on features given as numpy and as a torch tensor."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 16)).astype(np.float32)
    b = (rng.standard_normal((64, 16)) * 1.3 + 0.2).astype(np.float32)
    mu, sigma = tmetrics.activation_statistics(torch.from_numpy(a))
    jmu, jsigma = jmetrics.activation_statistics(a)
    np.testing.assert_allclose(mu, jmu, rtol=1e-6)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-6)
    m2, s2 = jmetrics.activation_statistics(b)
    want = jmetrics.frechet_distance(jmu, jsigma, m2, s2)
    assert tmetrics.frechet_distance(mu, sigma, m2, s2) == pytest.approx(
        want, rel=1e-6)
    assert tmetrics.fid(a, b) == pytest.approx(jmetrics.fid(a, b), rel=1e-6)
    assert tmetrics.fid(a, a) == pytest.approx(0.0, abs=1e-6)


def test_rfid_rand_and_auto_memoization(monkeypatch, tmp_path):
    """'auto' without the asset resolves to the seed-0 random extractor
    ('rfid-rand'), built once per (weights, device) and the same function
    in every process; features come in batches of ``batch``; an asset that
    appears later is picked up.  (Each 2048-d Fréchet distance costs a
    scipy ``sqrtm`` of some 20 s on an 8-core CPU, so this test stops at
    the features.)"""
    monkeypatch.setattr(tmetrics, '_EXTRACTOR_CACHE', {})
    monkeypatch.setattr(tmetrics, 'DEFAULT_INCEPTION',
                        str(tmp_path / 'inception_v3.npz'))
    built = []
    init = tinc.init_inception
    monkeypatch.setattr(tinc, 'init_inception',
                        lambda *a, **kw: built.append(1) or init(*a, **kw))
    f1, v1 = tmetrics.inception_extractor('auto', device='cpu')
    f2, v2 = tmetrics.inception_extractor('auto', device='cpu')
    assert v1 == v2 == 'rfid-rand' and f1 is f2 and len(built) == 1
    real = _images(6, 5, 32)
    feats = f1(real, batch=2)
    assert feats.shape == (5, tinc.POOL3_DIM) and feats.dtype == np.float32
    np.testing.assert_allclose(feats[3:], f1(real[3:]), rtol=1e-5, atol=1e-6)
    again = init(device='cpu')
    assert torch.equal(again(torch.from_numpy(real[:2])),
                       torch.from_numpy(f1(real[:2])))
    jck.save_params(str(tmp_path / 'inception_v3.npz'),
                    jinc.convert_inception(_torchvision_state_dict(
                        np.random.default_rng(9))))
    _, v3 = tmetrics.inception_extractor('auto', device='cpu')
    assert v3 == 'rfid-inception' and len(built) == 1


def test_vqgan_trainer_logs_rfid(tmp_path, monkeypatch):
    """``VQGANTrainer(eval_rfid=True).evaluate()`` logs the rFID of the
    reconstructions against the validation images under ``val
    <variant>``: ``rfid`` of those arrays on the trainer's device, here
    through a stand-in extractor of 6-d colour statistics (the 2048-d
    extractor and distance are held against JAX above); ``--eval-rfid``
    reaches the trainer."""
    from paintmind_tpu_torch.scripts import train_vqgan
    from paintmind_tpu_torch.utils import trainer as ttrainer
    calls = []

    def extractor(weights, device):
        calls.append((weights, device))

        def features(images, batch):
            x = np.asarray(images, np.float64).reshape(len(images), -1, 3)
            return np.concatenate([x.mean(1), x.std(1)], axis=1)
        return features, 'rfid-rand'

    monkeypatch.setattr(tmetrics, 'inception_extractor', extractor)
    vq = pt.create_model('vqgan', 'torch-rfid-vqgan', pretrained=False,
                         device='cpu')
    data = [torch.from_numpy(_images(10 + i, 1, 32)[0]) for i in range(20)]
    trainer = pt.VQGANTrainer(
        vq, data, num_epoch=1, valid_size=8, batch_size=4, num_workers=1,
        mixed_precision='no', perceptual_weights='none', eval_rfid=True,
        result_folder=str(tmp_path / 'vq'), log_dir=str(tmp_path / 'log'))
    trainer.evaluate()
    assert calls == [('auto', vq.device)]
    real = np.concatenate([np.asarray(ttrainer._first_images(b), np.float32)
                           for b in trainer.valid_dl])
    z, _, _ = vq.encode(real)
    fake = vq.decode(z).numpy()
    feats, _ = extractor('auto', vq.device)
    want = tmetrics.fid(feats(real, 32), feats(fake, 32))
    assert trainer.log['val rfid-rand'] == pytest.approx(want, rel=1e-6)
    assert np.isfinite(trainer.log['val psnr'])

    seen = {}
    monkeypatch.setattr(ttrainer.VQGANTrainer, 'train',
                        lambda self: seen.setdefault('rfid', self.eval_rfid))
    folder = tmp_path / 'jpegs'
    folder.mkdir()
    from PIL import Image
    for i in range(34):
        Image.fromarray((_images(40 + i, 1, 32)[0] * 127.5 + 127.5).astype(
            np.uint8)).save(folder / f'{i:02d}.jpg')
    train_vqgan.main(['--dataset', f'folder:{folder}', '--version',
                      'torch-rfid-vqgan', '--eval-rfid', '--perceptual',
                      'none', '--device', 'cpu', '--num-workers', '1',
                      '--result-folder', str(tmp_path / 'cli')])
    assert seen == {'rfid': True}
