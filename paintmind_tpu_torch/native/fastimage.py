"""ctypes bindings for the native fastimage library (see fastimage.cpp): the
port's counterpart of ``paintmind_tpu/native/fastimage.py``, with the same
entry points and the same crop and flip draws, so both give the same
batches for the same ``rng``.

The library is built with make on first use, into ``build/`` beside this
file under a name that carries a digest of the source and of the Makefile
(an edited source is rebuilt, a stale library never loaded).  Where the
build fails (no compiler, no libjpeg headers) ``is_available()`` is false
and every entry point raises with the build's error: there is no fallback
here; callers that want PIL use ``utils/transform``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, 'build')
_lock = threading.Lock()
_lib = None
_error = None


def library_path():
    digest = hashlib.sha256()
    for name in ('fastimage.cpp', 'Makefile'):
        with open(os.path.join(_DIR, name), 'rb') as f:
            digest.update(name.encode() + b'\0' + f.read())
    return os.path.join(BUILD_DIR, f'libfastimage-{digest.hexdigest()[:16]}.so')


def _build(path):
    """make into a temporary name, then rename: a library that is there is
    complete, whichever process built it."""
    tmp = f'{path}.{os.getpid()}.tmp'
    proc = subprocess.run(['make', '-s', '-C', _DIR, f'OUT={tmp}'],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'make failed ({proc.returncode}): '
                           f'{(proc.stdout + proc.stderr).strip()[-2000:]}')
    os.replace(tmp, path)


def _load():
    """The library, built at first use; None (and ``_error`` set) when it
    cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:  # no compiler, no libjpeg
            _error = f'{type(e).__name__}: {e}'
            return None
        lib.pm_batch_decode_preprocess.restype = ctypes.c_int
        lib.pm_batch_preprocess_rgb.restype = ctypes.c_int
        lib.pm_jpeg_shape.restype = ctypes.c_int
        _lib = lib
        return _lib


def is_available():
    return _load() is not None


def library():
    """The loaded library; raises with the build's error when there is none."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f'native fastimage library not available: {_error}'
                           ' (it needs a C++ compiler, make and the libjpeg '
                           'headers)')
    return lib


def _crop_params(n, resize, crop, is_train, hflip, rng):
    rng = rng or np.random.default_rng()
    max_off = resize - crop
    if is_train:
        tops = rng.integers(0, max_off + 1, n).astype(np.int32)
        lefts = rng.integers(0, max_off + 1, n).astype(np.int32)
        flips = ((rng.random(n) < 0.5) & hflip).astype(np.uint8)
    else:
        tops = np.full(n, max_off // 2, np.int32)
        lefts = np.full(n, max_off // 2, np.int32)
        flips = np.zeros(n, np.uint8)
    return tops, lefts, flips


def batch_decode_preprocess(jpeg_buffers, img_size=256, scale=0.8,
                            is_train=True, hflip=True, rng=None,
                            num_threads=None):
    """list of JPEG bytes → (N, img_size, img_size, 3) float32 in [-1, 1].
    Native equivalent of stage1_transform/stage2_transform applied to a
    batch.  Returns (batch, n_failed); a buffer that does not decode is
    zero-filled and counted."""
    lib = library()
    n = len(jpeg_buffers)
    resize = int(img_size / scale)
    tops, lefts, flips = _crop_params(n, resize, img_size, is_train, hflip, rng)

    bufs = [np.frombuffer(b, np.uint8) for b in jpeg_buffers]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    lens = (ctypes.c_size_t * n)(*[b.size for b in bufs])
    out = np.empty((n, img_size, img_size, 3), np.float32)
    failed = lib.pm_batch_decode_preprocess(
        ptrs, lens, n, resize, img_size,
        tops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lefts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads or os.cpu_count() or 1)
    return out, failed


def batch_preprocess_rgb(images, img_size=256, scale=0.8, is_train=True,
                         hflip=True, rng=None, num_threads=None):
    """list of HWC uint8 arrays → (N, img_size, img_size, 3) float32."""
    lib = library()
    n = len(images)
    resize = int(img_size / scale)
    tops, lefts, flips = _crop_params(n, resize, img_size, is_train, hflip, rng)
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for im in images])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    out = np.empty((n, img_size, img_size, 3), np.float32)
    lib.pm_batch_preprocess_rgb(
        ptrs, hs, ws, n, resize, img_size,
        tops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lefts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads or os.cpu_count() or 1)
    return out
