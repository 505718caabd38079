"""The port's data tier held against the JAX package on the CPU: the eight
dataset adapters, the tar-shard stream and its loader, and the native
(C++) image library and folder loader.

Every file is written here from a seed.  Dataset items and tar-shard
items must be bit-equal to JAX's, in the same order, with the same
captions under one ``np.random.seed``; the native library's batches
bit-equal to the JAX package's library on the same JPEGs (both are built
from the same source) and within JAX's stated tolerance (MAE < 2e-2) of
the port's PIL transform."""

import json
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from paintmind_tpu.native import fastimage as jfi
from paintmind_tpu.native import fastloader as jfl
from paintmind_tpu.utils import datasets as JD
from paintmind_tpu.utils import wds as jwds
from paintmind_tpu_torch.native import fastimage as tfi
from paintmind_tpu_torch.native import fastloader as tfl
from paintmind_tpu_torch.utils import datasets as TD
from paintmind_tpu_torch.utils import wds as twds
from paintmind_tpu_torch.utils.transform import stage1_transform


def _write_jpg(path, seed=0, size=(16, 20)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.random.default_rng(seed).integers(0, 255, (*size, 3),
                                               dtype=np.uint8)
    Image.fromarray(arr, 'RGB').save(path)


def _as_array(img):
    return np.asarray(img)


# ---------------------------------------------------------------------------
# dataset adapters
# ---------------------------------------------------------------------------

def _laion(root):
    import pandas as pd
    rows = []
    for i in range(5):
        folder, key = f'{i // 2:05d}', f'{i:09d}'
        _write_jpg(os.path.join(root, 'imgs', folder, f'{key}.jpg'), seed=i)
        rows.append({'folder': folder, 'key': key,
                     'caption': f'cap{i}', 'prompt': f'prompt{i}'})
    meta = os.path.join(root, 'meta.parquet')
    pd.DataFrame(rows).to_parquet(meta)
    return meta, os.path.join(root, 'imgs')


def _imagenet(root):
    for wnid, n in [('n01440764', 3), ('n01443537', 2)]:
        for j in range(n):
            _write_jpg(os.path.join(root, 'train', wnid, f'{wnid}_{j}.JPEG'),
                       seed=j + 10 * n)
    return root


def _flickr(root):
    for i, name in enumerate(('a.jpg', 'b.jpg', 'c.jpg')):
        _write_jpg(os.path.join(root, 'imgs', name), seed=i)
    ann = os.path.join(root, 'results_20130124.token')
    with open(ann, 'w', encoding='utf-8') as f:
        f.write('a.jpg#0\tfirst a\na.jpg#1\tsecond a\nb.jpg#0\tonly b\n'
                'c.jpg#0\tc one\nc.jpg#1\tc two\nc.jpg#2\tc three\n')
    return os.path.join(root, 'imgs'), ann


def _coco(root):
    images, anns = [], []
    for i in range(3):
        name = f'{i + 1:06d}.jpg'
        _write_jpg(os.path.join(root, 'train2017', name), seed=i)
        images.append({'id': i + 1, 'file_name': name})
        anns += [{'image_id': i + 1, 'caption': f'thing {i} {j}'}
                 for j in range(i + 1)]
    os.makedirs(os.path.join(root, 'annotations'))
    with open(os.path.join(root, 'annotations',
                           'captions_train2017.json'), 'w') as f:
        json.dump({'images': images, 'annotations': anns}, f)
    return root


def _celeba(root, zipped):
    src = os.path.join(root, 'stage') if zipped else os.path.join(root, 'Img')
    for i in range(4):
        _write_jpg(os.path.join(src, 'img_align_celeba', f'{i:06d}.jpg'),
                   seed=i)
    if zipped:
        os.makedirs(os.path.join(root, 'Img'))
        with zipfile.ZipFile(os.path.join(root, 'Img',
                                          'img_align_celeba.zip'), 'w') as zf:
            for i in range(4):
                name = f'img_align_celeba/{i:06d}.jpg'
                zf.write(os.path.join(src, name), name)
    os.makedirs(os.path.join(root, 'Anno'))
    with open(os.path.join(root, 'Anno', 'identity_CelebA.txt'), 'w') as f:
        f.write('000000.jpg 7\n000001.jpg 7\n000002.jpg 3\n000003.jpg 11\n')
    return root


def _folder(root):
    for i in range(4):
        _write_jpg(os.path.join(root, f'im_{i}.jpg'), seed=i)
    Image.fromarray(np.full((6, 6, 3), 9, np.uint8)).save(
        os.path.join(root, 'z.png'))
    open(os.path.join(root, 'notes.txt'), 'w').close()
    return root


def _diffusiondb_rows():
    rng = np.random.default_rng(3)
    return [{'image': Image.fromarray(rng.integers(0, 255, (8, 8, 3),
                                                   dtype=np.uint8)),
             'prompt': f'p{i}'} for i in range(3)]


def _adapters(kind, root):
    """(JAX adapter, port adapter) over the same files, both with an
    array-returning transform."""
    tf = _as_array
    if kind in ('laion', 'laion_v2'):
        meta, imgs = _laion(root)
        if kind == 'laion':
            return (JD.Laion(meta, imgs, transform=tf),
                    TD.Laion(meta, imgs, transform=tf))
        kw = dict(caption_col=('caption', 'prompt'), p=(0.3, 0.7), transform=tf)
        return JD.LaionV2(meta, imgs, **kw), TD.LaionV2(meta, imgs, **kw)
    if kind == 'imagenet':
        _imagenet(root)
        kw = dict(transform=tf, wnid_to_name={'n01440764': ['tench', 'carp']})
        return JD.ImageNet(root, **kw), TD.ImageNet(root, **kw)
    if kind == 'flickr30k':
        imgs, ann = _flickr(root)
        return (JD.Flickr30k(imgs, ann, transform=tf),
                TD.Flickr30k(imgs, ann, transform=tf))
    if kind == 'diffusiondb':
        rows = _diffusiondb_rows()
        return (JD.DiffusionDB(rows=rows, transform=tf),
                TD.DiffusionDB(rows=rows, transform=tf))
    if kind == 'coco':
        _coco(root)
        return JD.CoCo(root, transform=tf), TD.CoCo(root, transform=tf)
    if kind in ('celeba', 'celeba_zip'):
        _celeba(root, zipped=kind == 'celeba_zip')
        # the JAX adapter extracts the zip first; the port's then reads the
        # extracted tree, so build the port's on a second, untouched copy
        jds = JD.CelebA(root, transform=tf)
        if kind == 'celeba_zip':
            root2 = root + '_port'
            _celeba(root2, zipped=True)
            assert not os.path.isdir(os.path.join(root2, 'Img',
                                                  'img_align_celeba'))
            tds = TD.CelebA(root2, transform=tf)
            assert os.path.isdir(os.path.join(root2, 'Img', 'img_align_celeba'))
            return jds, tds
        return jds, TD.CelebA(root, transform=tf)
    assert kind == 'folder'
    _folder(root)
    return (JD.ImageFolder(root, transform=tf),
            TD.ImageFolder(root, transform=tf))


def _draw(ds, seed, rounds=4):
    """Every item ``rounds`` times under one global numpy seed."""
    np.random.seed(seed)
    return [ds[i] for _ in range(rounds) for i in range(len(ds))]


@pytest.mark.parametrize('kind', ['laion', 'laion_v2', 'imagenet', 'flickr30k',
                                  'diffusiondb', 'coco', 'celeba', 'celeba_zip',
                                  'folder'])
def test_dataset_adapters_match_jax(tmp_path, kind):
    """Each adapter gives JAX's items: images bit-equal, and the same
    captions (drawn from the global ``np.random`` state where the adapter
    samples one) or identities, in the same order."""
    jds, tds = _adapters(kind, str(tmp_path / 'data'))
    assert len(tds) == len(jds) > 0
    got, want = _draw(tds, 5), _draw(jds, 5)
    for g, w in zip(got, want):
        if kind == 'folder':
            g, w = (g, None), (w, None)
        np.testing.assert_array_equal(g[0], w[0])
        assert type(g[1]) is type(w[1]) and g[1] == w[1]
    if kind in ('laion_v2', 'imagenet', 'flickr30k', 'coco'):
        assert len({str(c) for _, c in got}) > len(tds)  # captions were drawn
    if kind == 'imagenet':
        assert tds.classes == jds.classes


def test_folder_paths_and_unzip(tmp_path):
    root = _folder(str(tmp_path / 'f'))
    assert TD.folder_paths(root) == JD.folder_paths(root)
    assert [os.path.basename(p) for p in TD.folder_paths(root)] == \
        ['im_0.jpg', 'im_1.jpg', 'im_2.jpg', 'im_3.jpg', 'z.png']
    with pytest.raises(RuntimeError, match='not a zip'):
        TD.unzip_file(os.path.join(root, 'notes.txt'), str(tmp_path / 'x'))
    with pytest.raises(RuntimeError, match='not found'):
        TD.CelebA(str(tmp_path / 'nowhere'))
    with pytest.raises(ValueError, match='no images'):
        TD.ImageFolder(str(tmp_path))


def test_lazy_optional_imports():
    """``pandas`` is imported by Laion only and ``datasets`` by DiffusionDB
    only without rows: neither by importing the module."""
    import subprocess
    import sys
    code = ('import sys; import paintmind_tpu_torch.utils.datasets as d; '
            'd.DiffusionDB(rows=[]); '
            'print([m for m in ("pandas", "datasets") if m in sys.modules])')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.strip() == '[]'


# ---------------------------------------------------------------------------
# tar shards
# ---------------------------------------------------------------------------

def _shards(tmp_path, n=23, shard_size=6):
    d = tmp_path / 'imgs'
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(n):
        arr = rng.integers(0, 255, (8 + i % 3, 8, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f'item_{i:03d}.png')
    caps = {f'item_{i:03d}.png': f'caption {i}' for i in range(0, n, 2)}
    j = jwds.write_shards(str(d), str(tmp_path / 'j' / 'train'), shard_size,
                          captions=caps)
    t = twds.write_shards(str(d), str(tmp_path / 't' / 'train'), shard_size,
                          captions=caps)
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j]
    for a, b in zip(j, t):
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read()
    for name in ('j', 't'):
        with open(str(tmp_path / name / 'train-index.json')) as f:
            assert json.load(f) == {'shards': [os.path.basename(p) for p in j],
                                    'counts': [6, 6, 6, 5]}
    return str(tmp_path / 'j' / 'train-*.tar')


def _items(ds, epochs=1):
    out = []
    for _ in range(epochs):
        out += list(ds)
    return out


def _assert_same_items(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, tuple) == isinstance(w, tuple)
        if isinstance(w, tuple):
            assert g[1] == w[1]
            g, w = g[0], w[0]
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('case', ['sequential', 'buffer8', 'two-epochs',
                                  'rank1of2', 'resume-mid-shard',
                                  'resume-mid-shard-buffer8', 'index-json'])
def test_sharded_tar_dataset_matches_jax(tmp_path, case):
    """The same shards give JAX's item sequence, bit-equal, with the same
    captions: shuffle buffer 0 and 8, two epochs, rank 1 of 2, a resume in
    the middle of a shard from ``state()`` (with and without a reservoir
    that spans shards), and the index sidecar as the pattern."""
    pattern = _shards(tmp_path)
    if case == 'index-json':
        pattern = pattern.replace('train-*.tar', 'train-index.json')
    kw = dict(transform=_as_array, seed=3,
              shuffle_buffer=8 if 'buffer8' in case else 0)
    if case == 'rank1of2':
        kw.update(rank=1, world_size=2)
    j = jwds.ShardedTarDataset(pattern, **kw)
    t = twds.ShardedTarDataset(pattern, **kw)
    assert len(t) == len(j) and t.shards == j.shards
    if case.startswith('resume'):
        for ds in (j, t):
            it = iter(ds)
            for _ in range(9):  # 9 of 23: inside the second shard
                next(it)
        assert t.state() == j.state() == {'epoch': 0, 'start_item': 9}
        j2 = jwds.ShardedTarDataset(pattern, **kw).set_epoch(**j.state())
        t2 = twds.ShardedTarDataset(pattern, **kw).set_epoch(**t.state())
        _assert_same_items(_items(t2), _items(j2))
        assert t2.state() == j2.state()
        return
    epochs = 2 if case == 'two-epochs' else 1
    _assert_same_items(_items(t, epochs), _items(j, epochs))
    assert t.state() == j.state() and t.epoch == j.epoch == epochs


def test_shard_granular_resume_matches_jax(tmp_path):
    pattern = _shards(tmp_path)
    j = jwds.ShardedTarDataset(pattern, transform=_as_array, seed=1)
    t = twds.ShardedTarDataset(pattern, transform=_as_array, seed=1)
    _assert_same_items(_items(t.set_epoch(1, start_shard=2)),
                       _items(j.set_epoch(1, start_shard=2)))


@pytest.mark.parametrize('drop_last', [True, False])
def test_iterable_loader_matches_jax(tmp_path, drop_last):
    """``IterableDataLoader`` over the stream: JAX's batches, bit-equal,
    with the port's collate (images (B, H, W, C) float32, captions a list);
    the last short batch only without ``drop_last``."""
    pattern = _shards(tmp_path)

    def crop(pil):  # the shards hold two image heights: collate needs one
        return np.asarray(pil)[:8]

    kw = dict(transform=crop, seed=2, shuffle_buffer=4, with_captions=True)
    j = jwds.IterableDataLoader(jwds.ShardedTarDataset(pattern, **kw), 5,
                                drop_last=drop_last)
    t = twds.IterableDataLoader(twds.ShardedTarDataset(pattern, **kw), 5,
                                drop_last=drop_last)
    assert len(t) == len(j) == (4 if drop_last else 5)
    got, want = list(t), list(j)
    assert [len(b[0]) for b in got] == [len(b[0]) for b in want] == \
        ([5] * 4 if drop_last else [5] * 4 + [3])
    for (gi, gc), (wi, wc) in zip(got, want):
        assert gi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        assert gc == wc


def test_vqgan_trainer_trains_from_tar_shards(tmp_path):
    """``VQGANTrainer`` consumes the streaming loader through its
    ``train_loader=`` / ``valid_loader=`` hook: 24 images, batch 8, three
    updates with a finite loss, an export and a state file."""
    import paintmind_tpu_torch as pt
    from paintmind_tpu_torch.models import discriminator as tdisc

    small = {'n_embed': 32, 'embed_dim': 8, 'beta': 0.25,
             'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
                     'num_head': 2, 'mlp_dim': 64, 'in_channels': 3,
                     'dim_head': 16, 'dropout': 0.0},
             'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
                     'num_head': 2, 'mlp_dim': 64, 'out_channels': 3,
                     'dim_head': 16, 'dropout': 0.0}}
    pt.register_version('torch-data-vqgan', small)
    d = tmp_path / 'imgs'
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(24):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
                        'RGB').save(d / f'{i:02d}.png')
    twds.write_shards(str(d), str(tmp_path / 'train'), shard_size=8)

    def tf(pil):
        return np.asarray(pil, np.float32) / 127.5 - 1.0

    train = twds.IterableDataLoader(
        twds.ShardedTarDataset(str(tmp_path / 'train-*.tar'), transform=tf,
                               shuffle_buffer=8), batch_size=8)
    valid = twds.IterableDataLoader(
        twds.ShardedTarDataset(str(tmp_path / 'train-00002.tar'),
                               transform=tf), batch_size=8)
    vq = pt.create_model('vqgan', 'torch-data-vqgan', pretrained=False,
                         device='cpu')
    trainer = pt.VQGANTrainer(
        vq, dataset=None, num_epoch=1, batch_size=8, num_workers=1,
        mixed_precision='no', save_every=100, sample_every=100,
        perceptual_weights='none',
        disc_config=tdisc.DiscriminatorConfig(input_nc=3, ndf=8, n_layers=2),
        result_folder=str(tmp_path / 'r'), log_dir=str(tmp_path / 'log'),
        train_loader=train, valid_loader=valid)
    trainer.train()
    assert trainer.steps == 3  # 24 images / batch 8
    assert np.isfinite(trainer.log['rec loss'])
    assert sorted(os.listdir(tmp_path / 'r' / 'models')) == [
        'vit_vq_state_3.pt', 'vit_vq_step_3.npz']


# ---------------------------------------------------------------------------
# the native library and loader
# ---------------------------------------------------------------------------

@pytest.fixture
def native():
    """Skips exactly where the JAX package's own native tests skip (its
    library cannot be built here); the port's library must then build."""
    if not jfi.is_available():
        pytest.skip('native toolchain unavailable (as tests/test_native.py)')
    assert tfi.is_available(), tfi._error
    return tfi


def _jpeg_bytes(arr, quality=95):
    import io
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'JPEG', quality=quality)
    return buf.getvalue()


def _rgb_images(n=5):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (200 + 17 * i, 260 - 23 * i, 3),
                         dtype=np.uint8) for i in range(n)]


@pytest.mark.parametrize('is_train', [True, False])
def test_native_batches_bit_equal_to_jax(native, is_train):
    """Both entry points, on the same JPEGs / arrays and the same seeded
    crop and flip draws: the port's batches are JAX's, bit for bit; a
    corrupt buffer is zero-filled and counted by both."""
    imgs = _rgb_images()
    jpegs = [_jpeg_bytes(im) for im in imgs] + [b'not a jpeg']
    kw = dict(img_size=64, scale=0.8, is_train=is_train, num_threads=3)
    got, failed = native.batch_decode_preprocess(
        jpegs, rng=np.random.default_rng(4), **kw)
    want, jfailed = jfi.batch_decode_preprocess(
        jpegs, rng=np.random.default_rng(4), **kw)
    assert failed == jfailed == 1 and not got[-1].any()
    np.testing.assert_array_equal(got, want)
    got = native.batch_preprocess_rgb(imgs, rng=np.random.default_rng(5), **kw)
    want = jfi.batch_preprocess_rgb(imgs, rng=np.random.default_rng(5), **kw)
    assert got.shape == (5, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_eval_within_tolerance_of_pil(native):
    """Eval mode against the port's PIL ``stage1_transform``: MAE < 2e-2
    per image (JAX's stated tolerance, tests/test_native.py), non-square
    images included."""
    import io
    imgs = _rgb_images(4)
    jpegs = [_jpeg_bytes(im) for im in imgs]
    out, failed = native.batch_decode_preprocess(jpegs, img_size=128,
                                                 is_train=False)
    assert failed == 0
    t = stage1_transform(img_size=128, is_train=False)
    for i, b in enumerate(jpegs):
        ref = t(Image.open(io.BytesIO(b)))
        assert float(np.abs(out[i] - ref).mean()) < 2e-2


@pytest.fixture
def jpeg_folder(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(11):
        arr = rng.integers(0, 255, (120 + 3 * i, 150 - 5 * i, 3),
                           dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f'im_{i:02d}.jpg', quality=95)
    return tmp_path


@pytest.mark.parametrize('is_train', [True, False])
def test_native_loader_matches_jax(native, jpeg_folder, is_train):
    """``NativeFolderLoader``: JAX's batch order (indices) and batches
    under one seed, over two epochs; with a corrupt JPEG in the folder,
    the same count of failures."""
    (jpeg_folder / 'im_03.jpg').write_bytes(b'not a jpeg')
    kw = dict(batch_size=3, img_size=64, is_train=is_train, seed=11,
              num_workers=3, drop_last=False, return_indices=True)
    j = jfl.NativeFolderLoader(jpeg_folder, **kw)
    t = tfl.NativeFolderLoader(jpeg_folder, **kw)
    try:
        assert len(t) == len(j) == 4 and t.paths == j.paths
        for _ in range(2):
            got, want = list(t), list(j)
            assert len(got) == len(want)
            for (gx, gi), (wx, wi) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gx, wx)
            assert t.failed == j.failed == 1
    finally:
        t.close()
        j.close()


def test_native_split_loaders_match_jax(native, jpeg_folder):
    paths = [str(p) for p in sorted(jpeg_folder.iterdir())]
    jt, jv = jfl.make_split_loaders(paths, 4, 2, valid_size=3, hflip=False,
                                    img_size=32, num_workers=2)
    tt, tv = tfl.make_split_loaders(paths, 4, 2, valid_size=3, hflip=False,
                                    img_size=32, num_workers=2)
    try:
        assert tt.paths == jt.paths and tv.paths == jv.paths
        for a, b in ((tt, jt), (tv, jv)):
            for x, y in zip(list(a), list(b)):
                np.testing.assert_array_equal(x, y)
    finally:
        for loader in (jt, jv, tt, tv):
            loader.close()


def test_native_loader_raises_without_the_library(monkeypatch, tmp_path):
    """Where the library cannot be built, creating a loader or calling an
    entry point raises with the build's error; ``is_available`` is false."""
    monkeypatch.setattr(tfi, '_lib', None)
    monkeypatch.setattr(tfi, '_error', 'RuntimeError: make failed (2): '
                        'jpeglib.h: No such file or directory')
    assert not tfi.is_available()
    _write_jpg(str(tmp_path / 'a.jpg'))
    with pytest.raises(RuntimeError, match='jpeglib.h'):
        tfl.NativeFolderLoader(tmp_path, batch_size=1)
    with pytest.raises(RuntimeError, match='not available'):
        tfi.batch_preprocess_rgb([np.zeros((8, 8, 3), np.uint8)], img_size=4)
