"""The port's device-side data tier (``paintmind_tpu_torch/ops/image.py``,
``utils/device_cache.py``, the trainers on a device cache) and its
profiling hooks (``utils/profiling.py``), held against the JAX package on
the CPU (the loaders here cache on ``device='cpu'``; on the card they
cache on ``cuda``, which ``chip_smoke.py`` drives).

Tolerances: resizes within 1e-5 absolute on [0, 1] images (the same
weights, contracted in another order); eval transforms and eval batches
bit-equal (the same uint8 pixels and the same fp32 ops); crops on the same
offsets bit-equal; the train transform within 1e-5 of JAX's on the same
offsets (its resize).  Random draws are torch's, so a train batch is held
against the explicit-offset crop of the loader's own draws, not JAX's.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.ops import image as jimage
from paintmind_tpu.utils import device_cache as jdc
import paintmind_tpu_torch as pt
from paintmind_tpu_torch.ops import image as timage
from paintmind_tpu_torch.utils import device_cache as tdc
from paintmind_tpu_torch.utils import profiling

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
TINY_PIPE = {'stage1': 'torch-cache-vqgan', 't5': 't5-l', 'dim': 32,
             'dim_head': 16, 'mlp_dim': 64, 'num_head': 2, 'depth': 1,
             'dropout': 0.0}
for _reg in (jcfg, pt):
    _reg.register_version('torch-cache-vqgan', TINY_VQ)
    _reg.register_version('torch-cache-pipeline', TINY_PIPE)


def _jpegs(folder, n=20):
    """Seeded JPEGs, every third one non-square."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        h, w = (48, 72) if i % 3 == 0 else (40, 40)
        low = rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)
        Image.fromarray(low).resize((w, h), Image.BICUBIC).save(
            os.path.join(folder, f'img_{i:02d}.jpg'), quality=92)
    return folder


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    return _jpegs(str(tmp_path_factory.mktemp('cache') / 'jpegs'))


@pytest.mark.parametrize('method', ['cubic', 'linear'])
@pytest.mark.parametrize('size', [24, 80], ids=['down', 'up'])
def test_resize_matches_jax(method, size):
    """``resize`` against ``jax.image.resize`` ('cubic' and 'bilinear'),
    shrinking (antialiased) and growing, on non-square images."""
    x = np.random.default_rng(1).random((2, 40, 56, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(
        jnp.asarray(x), (2, size, size, 3),
        'cubic' if method == 'cubic' else 'bilinear'))
    got = timage.resize(torch.from_numpy(x), size, method).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_transform_and_crop_match_jax():
    """The eval transform within 1e-5 of JAX's (its resize); the crop on
    explicit offsets and flips bit-equal to JAX's vmapped ``_crop_one`` and
    flip; the train transform on those offsets within 1e-5 of JAX's pieces;
    ``stage2`` never flips; drawn offsets lie in range."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    want = np.asarray(jimage.batched_transform(jnp.asarray(imgs), img_size=32,
                                               is_train=False))
    got = timage.batched_transform(torch.from_numpy(imgs), img_size=32,
                                   is_train=False)
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-5

    x = rng.random((3, 40, 40, 3)).astype(np.float32)
    tops, lefts = np.array([0, 3, 8]), np.array([8, 1, 0])
    flips = np.array([True, False, True])
    jc = jax.vmap(jimage._crop_one, in_axes=(0, 0, 0, None))(
        jnp.asarray(x), jnp.asarray(tops), jnp.asarray(lefts), 32)
    jc = jnp.where(jnp.asarray(flips)[:, None, None, None], jc[:, :, ::-1, :],
                   jc)
    tt = [torch.from_numpy(a) for a in (tops, lefts, flips)]
    tc = timage.crop(torch.from_numpy(x), *tt[:2], 32, tt[2])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    # the train transform on the same offsets: resize, clip, crop, flip
    resized = jnp.clip(jax.image.resize(
        jnp.asarray(imgs, jnp.float32) / 255.0, (3, 40, 40, 3), 'cubic'), 0, 1)
    jt = jax.vmap(jimage._crop_one, in_axes=(0, 0, 0, None))(
        resized, jnp.asarray(tops), jnp.asarray(lefts), 32)
    jt = jnp.where(jnp.asarray(flips)[:, None, None, None], jt[:, :, ::-1, :],
                   jt) * 2.0 - 1.0
    tt_ = timage.batched_transform(torch.from_numpy(imgs), img_size=32,
                                   tops=tt[0], lefts=tt[1], flips=tt[2])
    assert np.abs(tt_.numpy() - np.asarray(jt)).max() <= 1e-5

    g = torch.Generator().manual_seed(0)
    a = timage.stage1_transform_device(torch.from_numpy(imgs), g, img_size=32)
    g = torch.Generator().manual_seed(0)
    b = timage.stage1_transform_device(torch.from_numpy(imgs), g, img_size=32)
    assert torch.equal(a, b)  # one generator state, one batch
    t, l_, f = timage.draw_crops(64, 8, torch.Generator().manual_seed(1))
    assert int(t.min()) >= 0 and int(t.max()) <= 8 and int(l_.max()) <= 8
    assert 0 < int(f.sum()) < 64
    assert timage.draw_crops(4, 8, hflip=False)[2] is None
    with pytest.raises(ValueError, match='resize method'):
        timage.resize(torch.zeros(1, 4, 4, 3), 8, 'lanczos3')


def test_loader_eval_batches_match_jax(folder):
    """Eval batches (the center crop, ``drop_last=False`` with its tail)
    bit-equal to JAX's ``DeviceCacheLoader`` on the same folder, the tail
    included; ``return_indices`` and ``nbytes`` agree; every pixel value
    normalizes as JAX's compiled loader normalizes it."""
    u = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None, None],
                        (2, 256, 40, 3)).reshape(2, 40, 768, 1).repeat(3, -1)
    u = np.ascontiguousarray(u[:, :, :40])
    np.testing.assert_array_equal(
        tdc.DeviceCacheLoader(u, 2, img_size=32, is_train=False,
                              device='cpu').__iter__().__next__().numpy(),
        np.asarray(next(iter(jdc.DeviceCacheLoader(u, 2, img_size=32,
                                                   is_train=False)))))
    kw = dict(img_size=32, is_train=False, drop_last=False,
              return_indices=True)
    jl = jdc.DeviceCacheLoader(folder, 8, **kw)
    tl = tdc.DeviceCacheLoader(folder, 8, device='cpu', **kw)
    assert len(tl) == len(jl) == 3 and tl.nbytes == jl.nbytes
    assert tl._data.device.type == 'cpu'
    got, want = list(tl), list(jl)
    assert [b.shape[0] for b, _ in got] == [8, 8, 4]
    for (tb, ti), (jb, ji) in zip(got, want):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_loader_train_batches_follow_their_draws(folder):
    """Train batches equal ``ops.image.crop`` of the loader's own draws
    (``epoch_plan``); the tail with ``drop_last=False`` yields every item
    once; epochs reshuffle; one seed repeats, another differs; the split
    rule equals JAX's; a too-small corpus and a missing card refuse."""
    tl = tdc.DeviceCacheLoader(folder, 6, img_size=32, seed=5, device='cpu',
                               drop_last=False, return_indices=True)
    perm, plan = tl.epoch_plan(0)
    data = tl._data
    seen = []
    for step, (batch, idx) in enumerate(tl):
        tops, lefts, flips = plan[step]
        s = min(step * 6, tl.n - 6)
        want = timage.crop(data[perm[s:s + 6]], tops, lefts, 32, flips)
        want = tdc.normalize(want)[-batch.shape[0]:]
        assert torch.equal(batch, want)
        seen += idx.tolist()
    assert sorted(seen) == list(range(20))
    assert not torch.equal(tl.epoch_plan(1)[0], perm)  # reshuffled
    again = tdc.DeviceCacheLoader(folder, 6, img_size=32, seed=5,
                                  device='cpu')
    other = tdc.DeviceCacheLoader(folder, 6, img_size=32, seed=6,
                                  device='cpu')
    first = next(iter(again))
    assert torch.equal(first, next(iter(tdc.DeviceCacheLoader(
        folder, 6, img_size=32, seed=5, device='cpu'))))
    assert not torch.equal(first, next(iter(other)))
    assert len(again) == 3  # drop_last

    assert tdc.split_image_paths(folder) == jdc.split_image_paths(folder)
    train, valid = tdc.make_split_cache_loaders(folder, 4, 8, img_size=32,
                                                device='cpu')
    assert (train.n, valid.n, valid.batch_size) == (18, 2, 2)
    assert not valid.is_train and train.hflip
    with pytest.raises(ValueError, match='smaller than batch size'):
        tdc.DeviceCacheLoader(folder, 64, img_size=32, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdc.DeviceCacheLoader(folder, 4, img_size=32)


def test_trainers_on_a_device_cache(folder, tmp_path):
    """``VQGANTrainer`` and ``PaintMindTrainer`` take cached batches as they
    are (one update each, finite losses, ``evaluate()`` on the cached
    validation set), and ``train_vqgan`` / ``train_paintmind
    --device-cache`` build the split loaders (a non-folder dataset is
    refused with the JAX scripts' message)."""
    from paintmind_tpu_torch.scripts import train_paintmind, train_vqgan
    train, valid = tdc.make_split_cache_loaders(folder, 8, 4, img_size=32,
                                                device='cpu')
    vq = pt.create_model('vqgan', 'torch-cache-vqgan', pretrained=False,
                         device='cpu')
    seen = []
    trainer = pt.VQGANTrainer(
        vq, None, num_epoch=1, batch_size=8, mixed_precision='no',
        perceptual_weights='none', train_loader=train, valid_loader=valid,
        result_folder=str(tmp_path / 'vq'), log_dir=str(tmp_path / 'log'),
        save_every=100, sample_every=100, warmup_steps=1)
    step = trainer._step
    trainer._step = lambda imgs: seen.append(imgs) or step(imgs)
    batch = next(iter(train))
    m = trainer.train_step(batch)
    assert seen[0] is batch  # the cached tensor itself, no copy
    assert np.isfinite(float(m['loss']))
    trainer.evaluate()
    assert np.isfinite(trainer.log['val psnr'])

    common = ['--dataset', f'folder:{folder}', '--batch-size', '4',
              '--grad-accum', '1', '--epochs', '1', '--device-cache',
              '--device', 'cpu', '--num-workers', '1', '--sample-every',
              '1000', '--log-dir', str(tmp_path / 'log')]
    s1 = train_vqgan.main(common + [
        '--version', 'torch-cache-vqgan', '--perceptual', 'none',
        '--mixed-precision', 'no', '--save-every', '1000',
        '--result-folder', str(tmp_path / 'cli-vq')])
    assert isinstance(s1.train_dl, tdc.DeviceCacheLoader)
    assert s1.steps == 4 and np.isfinite(s1.log['loss'])
    stage1 = str(tmp_path / 'cli-vq' / 'models' / 'vit_vq_step_4.npz')
    s2 = train_paintmind.main(common + [
        '--version', 'torch-cache-pipeline', '--stage1-checkpoint', stage1,
        '--valid-size', '4', '--save-every', '1000', '--result-folder',
        str(tmp_path / 'cli-pm')])
    assert isinstance(s2.train_dl, tdc.DeviceCacheLoader)
    assert not s2.train_dl.hflip  # stage-2: no flip
    assert s2.steps == 4 and np.isfinite(s2.log['loss'])
    imagenet = tmp_path / 'imagenet'
    (imagenet / 'train').mkdir(parents=True)  # an empty split: no classes
    for main in (train_vqgan.main, train_paintmind.main):
        with pytest.raises(SystemExit, match='--device-cache needs a folder'):
            main(['--dataset', f'imagenet:{imagenet}', '--device-cache',
                  '--device', 'cpu'])


def test_profiling_on_the_cpu(tmp_path):
    """``trace`` writes a trace file that holds the ``annotate`` range (as a
    context manager and as a decorator); ``device_memory_stats`` is ``{}``
    for a CPU device and has JAX's key names on a card."""
    @profiling.annotate('decorated')
    def work(x):
        return (x @ x).sum()

    with profiling.trace(str(tmp_path / 'trace')) as prof:
        with profiling.annotate('block'):
            work(torch.ones(16, 16))
    names = {e.key for e in prof.key_averages()}
    assert {'block', 'decorated'} <= names
    files = os.listdir(tmp_path / 'trace')
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    text = (tmp_path / 'trace' / files[0]).read_text()
    assert '"block"' in text and '"decorated"' in text
    assert profiling.device_memory_stats('cpu') == {}
    if torch.cuda.is_available():
        stats = profiling.device_memory_stats()
        assert {'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'} <= set(
            stats)
    else:
        assert profiling.device_memory_stats() == {}
