"""Tracing and profiling hooks (``paintmind_tpu/utils/profiling.py``), on
``torch.profiler``: any train or sample loop can capture a trace that
TensorBoard (the PyTorch profiler plugin) or Perfetto reads.

    with profiling.trace('./trace') as prof:
        with profiling.annotate('generate'):
            pipe.generate(...)
        torch.cuda.synchronize()
    prof.key_averages()   # the window's operations, summed by name

Spans.  ``annotate(name, **attrs)`` is the port's one span facility, a
context manager and a decorator.  The port lays ``pm.*`` spans through its
hot paths (the sampler loop, the routed FFN, the stage-2 train step, the
serving engine and server) and ``pm.*`` counters beside them.  They are
**off** unless a ``torch.profiler`` session records, or the process is
inside a ``recording()`` block (process-wide, every thread):

    with profiling.recording():          # or inside profiling.trace(...)
        pipe.generate(...)
    snap = profiling.snapshot()
    snap['spans']['pm.step.draw']        # {'count', 'host_s', 'host_self_s',
                                         #  'device_s', 'device_self_s'}
    snap['counters']['pm.moe.kept']      # a number
    profiling.reset()

Off, ``annotate`` returns one shared no-op object: no
``record_function``, no clock read.  On, a span opens a
``record_function`` range while the profiler records (so it sits in the
trace beside the device rows), reads ``time.time_ns()`` at both ends (the
profiler trace's clock: an exported Chrome trace's ``ts`` plus
``baseTimeNanoseconds`` / 1000 is ``time_ns() / 1000``), keeps its parent
from a per-thread stack and an ``id`` attribute (its own, or its parent's:
the spans of one ``generate`` call or one served request share it), and,
once CUDA is initialised, records a pair of pooled timing events on the
current stream.  The events are read when they have completed, never by a
synchronisation on the hot path (``snapshot`` waits for the last ones);
each span then folds into its name's totals: the count, host seconds, host
self seconds (minus the children's), device seconds (the events' interval:
the kernels the span launched and any idle between them) and device self
seconds (``None`` without a card).  ``records()`` keeps the last
``RECORDS`` spans whole (name, start and end on the trace's clock, parent,
attributes, device seconds).  ``record(name, start_ns, end_ns, **attrs)``
adds an interval measured across threads (a request's queue wait);
``count(name, value)`` adds to a counter (a device tensor is summed on the
device and read at ``snapshot``).

CUDA graphs.  A captured graph replays its kernels without running the
Python that launched them, so neither its spans nor its counters record on
a replay.  ``tally()`` around a capture collects what the capture counts,
whether or not spans record (host numbers summed; device tensors summed by
kernels captured into the graph, so every replay refreshes them), and
``recount(tally)`` after each replay adds it to the counters while they
record.  Spans do not record inside a ``tally()`` block (a timing event
cannot be recorded into a capture); a span around the replay times it.

What the spans and counters are and which metric reads each:
``PERF.md`` section 3.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_ACTIVITIES = {'cpu': ProfilerActivity.CPU, 'cuda': ProfilerActivity.CUDA}

RECORDS = 4096     # whole spans kept for ``records()``
_DRAIN_AT = 256    # closed spans waiting for their events before a look


@contextlib.contextmanager
def trace(log_dir, *, activities=None):
    """A ``torch.profiler`` window over the enclosed block, yielding the
    profiler.  ``activities``: names out of ('cpu', 'cuda'); by default
    host and device activity ('cuda' only where a card is present).  On
    exit the trace is written under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``; ``log_dir=None`` writes no file
    (the profiler's ``key_averages()`` only: a window of some 30000
    device operations takes seconds to write).  The port's spans record
    inside it."""
    if activities is None:
        activities = ('cpu', 'cuda') if torch.cuda.is_available() else ('cpu',)
    handler = None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with profile(activities=[_ACTIVITIES[a] for a in activities],
                 on_trace_ready=handler) as prof:
        yield prof


# -- spans --------------------------------------------------------------

_recording = 0                  # depth of recording() blocks, process-wide
_lock = threading.Lock()        # guards everything below
_local = threading.local()      # .stack: this thread's open spans; .tally
_pending = collections.deque()  # closed spans whose events are unread
_events = []                    # pooled timing events
_totals = {}                    # name -> [count, host, host self, dev, dev self]
_counters = {}                  # name -> number or 0-d tensor
_records = collections.deque(maxlen=RECORDS)
_ids = itertools.count(1)


def enabled():
    """Whether spans and counters record now."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


def counting():
    """Whether a ``count`` now adds to something: the counters record, or
    this thread is inside a ``tally()`` block."""
    return enabled() or getattr(_local, 'tally', None) is not None


@contextlib.contextmanager
def tally():
    """Collect this thread's counts in the block into the yielded dict
    (name -> a number, or a 0-d device tensor) in place of the counters,
    whether or not they record; no span records inside.  Around a CUDA
    graph's capture (entered inside it): a counted tensor's sum is then
    formed by kernels of the graph, into a tensor that each replay
    rewrites (``recount``)."""
    counts, tensors = {}, {}
    _local.tally = (counts, tensors)
    try:
        yield counts
    finally:
        _local.tally = None
    for name, parts in tensors.items():
        counts[name] = torch.cat([t.reshape(-1) for t in parts]).sum()


def recount(counts):
    """Add a ``tally()``'s counts to the counters (after a replay of the
    graph they were captured with), when the counters record."""
    if not enabled():
        return
    for name, value in counts.items():
        count(name, value)


@contextlib.contextmanager
def recording():
    """Spans and counters record inside this block, in every thread,
    without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def new_id():
    """A fresh ``id`` attribute (a request's, given before its spans)."""
    return next(_ids)


class _Off:
    """The shared no-op span.  As a decorator it keeps the name and
    attributes ``annotate`` was last called with and gates every call."""

    name, attrs = None, {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(fn, self.name, dict(self.attrs))


_OFF = _Off()


def _decorate(fn, name, attrs):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with annotate(name, **attrs):
            return fn(*args, **kwargs)
    return wrapper


def annotate(name, **attrs):
    """A named span: a context manager, or a decorator (gated at every
    call).  ``attrs`` are kept with the span and given to the profiler's
    range as its ``args``; ``id`` is inherited from the parent span when
    not given (a span without one takes a fresh id)."""
    if not (_recording or _autograd_profiler._is_profiler_enabled) \
            or getattr(_local, 'tally', None) is not None:
        _OFF.name, _OFF.attrs = name, attrs
        return _OFF
    return _Span(name, attrs)


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    with _lock:
        if _events:
            return _events.pop()
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ('name', 'attrs', 'parent', 't0', 't1', 'child_host',
                 'child_dev', 'device_s', 'ev0', 'ev1', 'rf')

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __call__(self, fn):
        return _decorate(fn, self.name, dict(self.attrs))

    def __enter__(self):
        stack = _stack()
        parent = self.parent = stack[-1] if stack else None
        attrs = self.attrs
        if 'id' not in attrs:
            attrs['id'] = parent.attrs['id'] if parent is not None \
                else next(_ids)
        self.child_host = self.child_dev = 0.0
        self.device_s = self.rf = self.ev0 = self.ev1 = None
        ev0 = _event() if torch.cuda.is_initialized() else None
        stack.append(self)
        # the clock is read next to the range's own reading
        self.t0 = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function(
                self.name, ' '.join(f'{k}={v}' for k, v in attrs.items()))
            self.rf.__enter__()
        if ev0 is not None:
            ev0.record()
            self.ev0 = ev0
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = _event()
            self.ev1.record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        t1 = self.t1 = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.parent is not None:
            self.parent.child_host += (t1 - self.t0) * 1e-9
        with _lock:
            _records.append(self)
            if self.ev0 is None:
                _fold(self)
            else:
                _pending.append(self)
                if len(_pending) >= _DRAIN_AT:
                    _drain(wait=False)
        return False


def _fold(span):
    """Add a closed span (its events read) to its name's totals."""
    host = (span.t1 - span.t0) * 1e-9
    tot = _totals.get(span.name)
    if tot is None:
        tot = _totals[span.name] = [0, 0.0, 0.0, None, None]
    tot[0] += 1
    tot[1] += host
    tot[2] += host - span.child_host
    dev = span.device_s
    if dev is not None:
        tot[3] = (tot[3] or 0.0) + dev
        tot[4] = (tot[4] or 0.0) + dev - span.child_dev
        if span.parent is not None:
            span.parent.child_dev += dev


def _drain(wait):
    """Fold the pending spans in the order they closed (children before
    their parents), up to the first whose end event has not completed;
    with ``wait``, all of them.  Called under ``_lock``."""
    while _pending:
        span = _pending[0]
        if wait:
            span.ev1.synchronize()
        elif not span.ev1.query():
            return
        _pending.popleft()
        span.device_s = span.ev0.elapsed_time(span.ev1) * 1e-3
        _events.extend((span.ev0, span.ev1))
        span.ev0 = span.ev1 = None
        _fold(span)


def record(name, start_ns, end_ns, **attrs):
    """A span measured by the caller, on the trace's clock
    (``time.time_ns()``), e.g. across threads: host time only, no parent."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    span = _Span(name, attrs)
    span.parent = None
    span.t0, span.t1 = int(start_ns), int(end_ns)
    span.child_host = span.child_dev = 0.0
    span.device_s = None
    with _lock:
        _records.append(span)
        _fold(span)


def count(name, value):
    """Add ``value`` (a number, or a tensor: its sum, taken on its device
    and read at ``snapshot``) to the counter ``name``, or inside a
    ``tally()`` block to its tally."""
    held = getattr(_local, 'tally', None)
    if held is not None:
        counts, tensors = held
        if isinstance(value, torch.Tensor):
            tensors.setdefault(name, []).append(value.detach())
        else:
            counts[name] = counts.get(name, 0) + value
        return
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
    with _lock:
        prev = _counters.get(name)
        _counters[name] = value if prev is None else prev + value


def snapshot():
    """The totals of the spans closed and the counters since the last
    ``reset``: ``{'spans': {name: {'count', 'host_s', 'host_self_s',
    'device_s', 'device_self_s'}}, 'counters': {name: float}}``.  Waits
    for the device events still pending."""
    with _lock:
        _drain(wait=True)
        spans = {n: {'count': c, 'host_s': h, 'host_self_s': hs,
                     'device_s': d, 'device_self_s': ds}
                 for n, (c, h, hs, d, ds) in _totals.items()}
        counters = dict(_counters)
    return {'spans': spans,
            'counters': {n: float(v) for n, v in counters.items()}}


def records():
    """The last ``RECORDS`` closed spans, oldest first: dicts of ``name``,
    ``start_ns``, ``end_ns`` (the trace's clock), ``parent`` (its name or
    None), ``attrs`` and ``device_s`` (None until its events are read, or
    without a card)."""
    with _lock:
        spans = list(_records)
    return [{'name': s.name, 'start_ns': s.t0, 'end_ns': s.t1,
             'parent': None if s.parent is None else s.parent.name,
             'attrs': dict(s.attrs), 'device_s': s.device_s} for s in spans]


def reset():
    """Forget every total, counter and record (spans still open fold in
    when they close)."""
    with _lock:
        _drain(wait=True)
        _totals.clear()
        _counters.clear()
        _records.clear()


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
