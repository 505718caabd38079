"""Dataset adapters — the reference's seven map-style datasets
(paintmind/utils/datasets.py) — the port's own copy of
``paintmind_tpu/utils/datasets.py``: the same files, the same items and the
same global ``np.random`` draws, so both packages give one caption sequence
under one ``np.random.seed``.  Each returns ``(img, caption)`` (CelebA
returns ``(img, id)``), applying the given transform (utils/transform) to a
PIL image.  ``pandas`` is imported by ``Laion`` only, ``datasets`` by
``DiffusionDB`` only when no ``rows`` are given.

Differences from the reference, by necessity of the environment:
  * ImageNet (reference :75-91 uses torchvision.datasets.ImageNet) reads the
    standard ``<root>/<split>/<wnid>/*.JPEG`` layout directly; class names
    come from an optional ``wnid_to_name`` mapping (or the wnid itself).
  * CoCo (reference :132-154 uses pycocotools) parses the captions
    annotation JSON with the stdlib — same files, same sampling behavior.
  * Flickr30k (reference :94-109 uses torchvision) parses the
    ``results_20130124.token`` annotation format directly.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
from PIL import Image


def unzip_file(zip_src, tgt_dir):
    """Extract a zip archive (reference datasets.py:11-17 contract)."""
    if not zipfile.is_zipfile(zip_src):
        raise RuntimeError(f'{zip_src} is not a zip archive')
    with zipfile.ZipFile(zip_src) as zf:
        zf.extractall(tgt_dir)


def _open_rgb(path):
    return Image.open(path).convert('RGB')


def _laion_columns(metadata_path, folder_path, fid, key, caption_cols):
    """Vectorized parquet → (paths (N,), captions (N, C)) numpy columns.

    One pass over the metadata at construction instead of per-item pandas
    lookups; image layout is ``<folder_path>/<fid>/<key>.jpg`` (reference
    datasets.py:20-42)."""
    import pandas as pd
    meta = pd.read_parquet(metadata_path,
                           columns=[fid, key, *caption_cols])
    paths = (folder_path + os.sep + meta[fid].astype(str)
             + os.sep + meta[key].astype(str) + '.jpg').to_numpy()
    captions = np.stack([meta[c].astype(str).to_numpy()
                         for c in caption_cols], axis=1)
    return paths, captions


class Laion:
    """LAION shard: parquet metadata + image tree (reference
    datasets.py:20-42 capability).  Metadata is materialized into flat
    numpy columns once, so workers never touch pandas."""

    def __init__(self, metadata_path, folder_path, fid='folder', key='key',
                 caption_col='caption', transform=None):
        self._paths, self._captions = _laion_columns(
            metadata_path, folder_path, fid, key, [caption_col])
        self.transform = transform

    def __len__(self):
        return self._paths.shape[0]

    def __getitem__(self, idx):
        img = _open_rgb(self._paths[idx])
        if self.transform is not None:
            img = self.transform(img)
        return img, str(self._captions[idx, 0])


class LaionV2(Laion):
    """LAION shard with several caption columns, one drawn per item with
    the given probabilities (reference datasets.py:45-72 capability)."""

    def __init__(self, metadata_path, folder_path, fid='folder', key='key',
                 caption_col=('caption', 'prompt'), p=(0.2, 0.8),
                 transform=None):
        self._paths, self._captions = _laion_columns(
            metadata_path, folder_path, fid, key, list(caption_col))
        self._probs = np.asarray(p, np.float64)
        self.transform = transform

    def __getitem__(self, idx):
        img = _open_rgb(self._paths[idx])
        if self.transform is not None:
            img = self.transform(img)
        which = np.random.choice(self._probs.shape[0], p=self._probs)
        return img, str(self._captions[idx, which])


class ImageNet:
    """(reference datasets.py:75-91): images with 'an image of <class>'-style
    captions.  Reads <root>/<split>/<wnid>/*; pass wnid_to_name (dict or
    path to a json/txt mapping) for human-readable class names."""

    prefix = ['an image of ', 'a picture of ']

    def __init__(self, root, split='train', transform=None, wnid_to_name=None):
        split_dir = os.path.join(root, split)
        self.samples = []
        wnids = sorted(d for d in os.listdir(split_dir)
                       if os.path.isdir(os.path.join(split_dir, d)))
        for wnid in wnids:
            d = os.path.join(split_dir, wnid)
            for fname in sorted(os.listdir(d)):
                self.samples.append((os.path.join(d, fname), wnid))
        if isinstance(wnid_to_name, str):
            with open(wnid_to_name) as f:
                wnid_to_name = json.load(f)
        self.wnid_to_name = wnid_to_name or {}
        self.classes = [self.wnid_to_name.get(w, w) for w in wnids]
        self.transform = transform

    def __getitem__(self, idx):
        path, wnid = self.samples[idx]
        image = _open_rgb(path)
        name = self.wnid_to_name.get(wnid, wnid)
        if isinstance(name, (list, tuple)):
            name = np.random.choice(list(name))
        caption = np.random.choice(self.prefix) + str(name)
        if self.transform is not None:
            image = self.transform(image)
        return image, caption

    def __len__(self):
        return len(self.samples)


class Flickr30k:
    """(reference datasets.py:94-109): random caption per image from the
    results_20130124.token annotation file (lines: 'img.jpg#i\\tcaption')."""

    def __init__(self, img_dir, ann_file, transform=None):
        self.img_dir = img_dir
        anns = {}
        with open(ann_file, encoding='utf-8') as f:
            for line in f:
                head, _, caption = line.strip().partition('\t')
                img_id = head.split('#')[0]
                anns.setdefault(img_id, []).append(caption)
        self.items = sorted(anns.items())
        self.transform = transform

    def __getitem__(self, idx):
        img_id, captions = self.items[idx]
        img = _open_rgb(os.path.join(self.img_dir, img_id))
        caption = np.random.choice(captions)
        if self.transform is not None:
            img = self.transform(img)
        return img, caption

    def __len__(self):
        return len(self.items)


class DiffusionDB:
    """Stable-Diffusion prompt/image pairs from the HF hub (reference
    datasets.py:112-129 capability: poloclub/diffusiondb)."""

    _HUB_ID = 'poloclub/diffusiondb'

    def __init__(self, version='large_random_100k', transform=None,
                 rows=None):
        if rows is None:
            from datasets import load_dataset
            rows = load_dataset(self._HUB_ID, version, split='train')
        self._rows = rows  # injectable for offline tests
        self.transform = transform

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, idx):
        row = self._rows[int(idx)]
        img = row['image']
        if self.transform is not None:
            img = self.transform(img)
        return img, row['prompt']


class CoCo:
    """(reference datasets.py:132-154): COCO captions; the annotation JSON
    is parsed directly (images + annotations tables) — same behavior as the
    pycocotools path: random caption among the image's annotations."""

    def __init__(self, root, dataType='train2017', annType='captions',
                 transform=None):
        self.img_dir = f'{root}/{dataType}'
        ann_file = f'{root}/annotations/{annType}_{dataType}.json'
        with open(ann_file) as f:
            ann = json.load(f)
        self.img_info = {im['id']: im['file_name'] for im in ann['images']}
        self.img_anns = {}
        for a in ann['annotations']:
            self.img_anns.setdefault(a['image_id'], []).append(a['caption'])
        self.imgids = sorted(self.img_info)
        self.transform = transform

    def __getitem__(self, idx):
        imgid = self.imgids[idx]
        img = _open_rgb(os.path.join(self.img_dir, self.img_info[imgid]))
        ann = np.random.choice(self.img_anns.get(imgid, ['']))
        if self.transform is not None:
            img = self.transform(img)
        return img, ann

    def __len__(self):
        return len(self.imgids)


class CelebA:
    """CelebA faces with identity labels; returns ``(img, identity_id)``
    (reference datasets.py:157-196 capability: zip auto-extract + the
    ``Anno/identity_CelebA.txt`` table).  Items are a flat record list of
    (path, identity) built at construction."""

    def __init__(self, root, type='identity', transform=None):
        img_root = self._materialize_images(os.path.join(root, 'Img'))
        idents = ({} if type != 'identity' else self._read_identities(
            os.path.join(root, 'Anno', 'identity_CelebA.txt')))
        self._records = [
            (os.path.join(img_root, name), idents.get(name, 0))
            for name in sorted(os.listdir(img_root))]
        self.transform = transform

    @staticmethod
    def _materialize_images(base_dir):
        target = os.path.join(base_dir, 'img_align_celeba')
        if os.path.isdir(target):
            return target
        archive = target + '.zip'
        if not os.path.exists(archive):
            raise RuntimeError(
                f'CelebA images not found: neither {target} nor {archive}')
        unzip_file(archive, base_dir)
        return target

    @staticmethod
    def _read_identities(ann_path):
        with open(ann_path) as f:
            pairs = (line.split() for line in f if line.strip())
            return {name: int(ident) for name, ident in pairs}

    def __len__(self):
        return len(self._records)

    def __getitem__(self, idx):
        path, ident = self._records[idx]
        img = _open_rgb(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(ident)


IMAGE_EXTS = ('.jpg', '.jpeg', '.png')


def folder_paths(root, exts=IMAGE_EXTS):
    """Sorted image paths directly under ``root`` (extension extension —
    the reference has no plain-folder adapter)."""
    return [os.path.join(root, f) for f in sorted(os.listdir(root))
            if f.lower().endswith(exts)]


class ImageFolder:
    """Caption-less flat folder of images → transformed image per item.
    Shared by the training CLIs (stage-1 images-only contract,
    reference README.md:77) and usable for unconditional stage-2 runs."""

    def __init__(self, root, transform=None, exts=IMAGE_EXTS):
        self.paths = folder_paths(root, exts)
        if not self.paths:
            raise ValueError(f'no images ({", ".join(exts)}) under {root}')
        self.transform = transform

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        img = _open_rgb(self.paths[i])
        return self.transform(img) if self.transform else img
