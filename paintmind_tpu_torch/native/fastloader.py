"""Python wrapper for the native pipelined folder loader (fastimage.cpp):
the port's counterpart of ``paintmind_tpu/native/fastloader.py`` (same
batch order under one seed, same failure count).

``NativeFolderLoader`` is a drop-in for the host DataLoader on image-folder
datasets: a C++ worker pool reads + decodes + preprocesses JPEGs into an
in-order bounded prefetch queue, so the Python consumer thread only copies
finished float32 batches (the reference delegates this tier to torch
DataLoader workers via accelerate.prepare; trainer.py:115-133).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import fastimage


def _lib():
    lib = fastimage.library()  # raises when the library cannot be built
    if not getattr(lib, '_loader_decls', False):
        lib.pm_loader_create.restype = ctypes.c_void_p
        lib.pm_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.pm_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pm_loader_num_batches.restype = ctypes.c_int
        lib.pm_loader_num_batches.argtypes = [ctypes.c_void_p]
        lib.pm_loader_next.restype = ctypes.c_int
        lib.pm_loader_next.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.pm_loader_failed_count.restype = ctypes.c_int
        lib.pm_loader_failed_count.argtypes = [ctypes.c_void_p]
        lib.pm_loader_destroy.argtypes = [ctypes.c_void_p]
        lib._loader_decls = True
    return lib


def is_available():
    return fastimage.is_available()


class NativeFolderLoader:
    """Iterate (batch,) or (batch, indices) over a folder of JPEGs.

    Matches the host DataLoader protocol the trainers use (`__len__`,
    `__iter__`, per-epoch reshuffle).  Decode failures are zero-filled and
    counted in ``failed`` rather than raising, mirroring
    pm_batch_decode_preprocess semantics.
    """

    def __init__(self, root_or_paths, batch_size, *, img_size=256, scale=0.8,
                 is_train=True, hflip=True, seed=0, num_workers=None,
                 prefetch=4, drop_last=True, return_indices=False):
        if isinstance(root_or_paths, (list, tuple)):
            self.paths = [str(p) for p in root_or_paths]
        else:
            root = str(root_or_paths)
            self.paths = [os.path.join(root, f) for f in sorted(os.listdir(root))
                          if f.lower().endswith(('.jpg', '.jpeg'))]
        if not self.paths:
            raise ValueError('no JPEG files to load')
        self.batch_size = int(batch_size)
        self.img_size = int(img_size)
        self.return_indices = return_indices
        self.epoch = 0
        self._lib = _lib()
        resize = int(img_size / scale)
        self._cpaths = [p.encode() for p in self.paths]
        arr = (ctypes.c_char_p * len(self._cpaths))(*self._cpaths)
        self._handle = self._lib.pm_loader_create(
            arr, len(self._cpaths), self.batch_size, resize, self.img_size,
            int(is_train), int(hflip), ctypes.c_uint64(seed),
            num_workers or os.cpu_count() or 1, prefetch, int(drop_last))
        if not self._handle:
            raise RuntimeError('pm_loader_create failed (bad parameters)')

    def __len__(self):
        return self._lib.pm_loader_num_batches(self._handle)

    @property
    def failed(self):
        """Decode failures in the current/last epoch."""
        return self._lib.pm_loader_failed_count(self._handle)

    def __iter__(self):
        self._lib.pm_loader_start_epoch(self._handle, self.epoch)
        cs = self.img_size
        try:
            while True:
                out = np.empty((self.batch_size, cs, cs, 3), np.float32)
                idx = np.empty(self.batch_size, np.int32)
                n = self._lib.pm_loader_next(
                    self._handle, out.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float)),
                    idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
                if n == 0:
                    break
                batch = out[:n]
                yield (batch, idx[:n].copy()) if self.return_indices else batch
        finally:
            self.epoch += 1

    def close(self):
        if getattr(self, '_handle', None):
            self._lib.pm_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown
            pass


def make_split_loaders(paths, train_batch, valid_batch, *, valid_size=32,
                       seed=42, hflip=True, img_size=256, num_workers=None):
    """Deterministic train/valid split over JPEG ``paths`` → a shuffling
    train loader + an eval-transform valid loader (the native counterpart
    of the trainers' random_split + two DataLoaders)."""
    paths = [p for p in paths if p.lower().endswith(('.jpg', '.jpeg'))]
    if not paths:
        raise ValueError('no JPEG paths for the native loader')
    perm = np.random.default_rng(seed).permutation(len(paths))
    valid_n = min(valid_size, max(len(paths) // 10, 1))
    train = NativeFolderLoader(
        [paths[i] for i in perm[valid_n:]], train_batch, img_size=img_size,
        is_train=True, hflip=hflip, seed=seed, num_workers=num_workers)
    valid = NativeFolderLoader(
        [paths[i] for i in perm[:valid_n]], min(valid_batch, valid_n),
        img_size=img_size, is_train=False, drop_last=False,
        num_workers=num_workers)
    print(f'native loader: {len(paths) - valid_n} train / {valid_n} valid '
          'JPEGs')
    return train, valid
