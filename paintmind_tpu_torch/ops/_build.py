"""Builds the CUDA kernels in ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for sm_90a into its own shared library under ``csrc/build/``, named
by a digest of the source, of every shared header ``csrc/*.cuh`` and of the
flags, so an edited source or header is rebuilt and a stale library is never
loaded.  The build runs at first use (or up front
through :func:`build`, which starts one ``nvcc`` per source, all at once).
Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC / 'build'
KERNELS = ('flash_attention', 'flash_attention_bwd', 'vq_lookup', 'sampling',
           'moe_experts', 'rope')
# --split-compile=0: the kernels of one source are optimised on all cores (the
# sampling head's six instantiations are the longest build)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--split-compile=0', '-shared', '-Xcompiler', '-fPIC', '-Xptxas',
              '-v')

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, 'bin', name)
        if os.path.exists(path):
            return path
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f'{name} not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit (set CUDA_HOME)')
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in (CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))):
        digest.update(src.name.encode() + b'\0' + src.read_bytes())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the build
    seconds of each (0.0 where the library was already built); raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool('nvcc')
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        log = open(out.with_suffix('.log'), 'w')
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
             str(CSRC / f'{name}.cu')],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f'{name} (nvcc exit {rc}):\n'
                          + out.with_suffix('.log').read_text())
    if failed:
        raise RuntimeError('kernel build failed: ' + '\n'.join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (ptxas registers / shared memory)."""
    log = library_path(name).with_suffix('.log')
    return log.read_text() if log.exists() else ''


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build((name,))
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {err}')
