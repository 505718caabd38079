"""Tracing and profiling hooks (``paintmind_tpu/utils/profiling.py``), on
``torch.profiler``: any train or sample loop can capture a trace that
TensorBoard (the PyTorch profiler plugin) or Perfetto reads.

    with profiling.trace('./trace') as prof:
        with profiling.annotate('generate'):
            pipe.generate(...)
        torch.cuda.synchronize()
    prof.key_averages()   # the window's operations, summed by name
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_ACTIVITIES = {'cpu': ProfilerActivity.CPU, 'cuda': ProfilerActivity.CUDA}


@contextlib.contextmanager
def trace(log_dir, *, activities=None):
    """A ``torch.profiler`` window over the enclosed block, yielding the
    profiler.  ``activities``: names out of ('cpu', 'cuda'); by default
    host and device activity ('cuda' only where a card is present).  On
    exit the trace is written under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``; ``log_dir=None`` writes no file
    (the profiler's ``key_averages()`` only: a window of some 30000
    device operations takes seconds to write)."""
    if activities is None:
        activities = ('cpu', 'cuda') if torch.cuda.is_available() else ('cpu',)
    handler = None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with profile(activities=[_ACTIVITIES[a] for a in activities],
                 on_trace_ready=handler) as prof:
        yield prof


def annotate(name):
    """A named range on the profiler's timeline, usable as a context
    manager and as a decorator."""
    return record_function(name)


def device_memory_stats(device=None):
    """The device allocator's state under the JAX package's key names:
    ``bytes_in_use``, ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``), ``bytes_limit`` (the card's
    memory) and ``bytes_reserved`` (held by PyTorch's caching allocator);
    ``{}`` for a CPU device, as JAX gives for one.  ``device=None``: the
    current CUDA device, or the CPU without a card."""
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device)
    if device.type != 'cuda':
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {'bytes_in_use': stats.get('allocated_bytes.all.current', 0),
            'peak_bytes_in_use': stats.get('allocated_bytes.all.peak', 0),
            'bytes_limit': total,
            'bytes_reserved': stats.get('reserved_bytes.all.current', 0)}
