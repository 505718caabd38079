"""Multi-process entry helpers (``paintmind_tpu/parallel/multihost.py``).

One process per GPU, as ``torchrun`` starts them.  ``initialize`` creates
the default process group: NCCL for ``device='cuda'`` (the rank binds to
``cuda:{LOCAL_RANK}``), gloo for ``device='cpu'``.  Nothing falls back: no
card or no NCCL on ``'cuda'`` raises."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def launched():
    """True in a process ``torchrun`` started (its environment is set)."""
    return all(k in os.environ for k in _ENV)


def local_rank():
    return int(os.environ.get('LOCAL_RANK', 0))


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device='cuda'):
    """Create the default process group, once per process.  With no
    arguments it reads ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); else
    ``coordinator_address`` is ``host:port`` of rank 0 and
    ``num_processes`` / ``process_id`` the world size and this rank.
    Returns the JAX package's keys: ``process_index``, ``process_count``,
    ``local_devices`` (one device per process) and ``global_devices``."""
    if device not in ('cuda', 'cpu'):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('multihost.initialize(device=\'cuda\'): no CUDA '
                               "device; pass device='cpu' for gloo")
        if not dist.is_nccl_available():
            raise RuntimeError('multihost.initialize(device=\'cuda\'): this '
                               'PyTorch has no NCCL')
    backend = 'nccl' if device == 'cuda' else 'gloo'
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f'a {dist.get_backend()} process group exists; '
                               f'{backend} was asked for')
    else:
        if coordinator_address is None:
            missing = [k for k in _ENV if k not in os.environ]
            if missing:
                raise ValueError(
                    'multihost.initialize() without arguments reads '
                    f'torchrun\'s environment; {missing} are not set (run '
                    'under torchrun, or pass coordinator_address, '
                    'num_processes and process_id)')
            init = dict(init_method='env://')
        else:
            if num_processes is None or process_id is None:
                raise ValueError('coordinator_address needs num_processes '
                                 'and process_id')
            os.environ.setdefault('LOCAL_RANK', str(process_id
                                                    % max(torch.cuda.device_count(), 1)
                                                    if device == 'cuda' else 0))
            init = dict(init_method=f'tcp://{coordinator_address}',
                        world_size=int(num_processes), rank=int(process_id))
        if device == 'cuda':
            torch.cuda.set_device(local_rank())
            init['device_id'] = torch.device('cuda', local_rank())
        dist.init_process_group(backend, **init)
    world = dist.get_world_size()
    return {'process_index': dist.get_rank(), 'process_count': world,
            'local_devices': 1, 'global_devices': world}


def world_size():
    return dist.get_world_size()


def device():
    """This process's device under the default process group."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', local_rank())
    return torch.device('cpu')


def is_main_process():
    """Rank 0 (or a process with no process group) logs and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    if dist.is_initialized():
        dist.barrier()


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()
