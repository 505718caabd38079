"""Dynamic-batching inference engine for the MaskGIT pipeline
(``paintmind_tpu/serving/engine.py``).

The engine queues concurrent generation, paint and reconstruction requests,
coalesces compatible ones into padded batches, runs them on one dispatch
thread (one stream of device work, no contention for the card) and fulfils
per-request futures with (H, W, 3) float32 numpy images in [-1, 1].

  * The unit of scheduling is a whole 16-18-step MaskGIT sample: wait up to
    ``max_wait_ms`` for requests with the same signature, pad the group to
    a power-of-two bucket capped at ``max_batch``, run once.  Eager PyTorch
    compiles nothing per shape, but the bucket is still the engine's
    contract: ``padded_slots`` counts it, and it is the batch shape the
    sampling kernel (K3) and cuBLAS see.
  * A signature is what splits a batch: (kind, context length, timesteps,
    top-k, guided?, cfg_warmup).  Temperature and guidance scale are
    per-sample (B,) vectors, and paint rects and modes per-sample latent
    keep-masks (``Pipeline.paint``), so requests that differ only in those
    share a batch.
  * All device work of a batch runs on the dispatch thread, in inference
    mode, with the thread's current device pinned to the pipeline's; the
    batch's images come to the host once, there.  Prompts are encoded by the
    pipeline's tower on the submitting thread (``submit``), as in JAX.
  * Seeds: the seeds of a batch's requests fold into one 64-bit seed
    (``fold_seeds``, a splitmix64 mix) of a ``torch.Generator`` on the
    pipeline's device; a batch without seeds draws one from
    ``numpy.random.default_rng()``.  As in JAX, a seeded request is
    reproducible only for an identical batch composition.

Multi-GPU (``mesh=``, ``sequence_parallel=``, ``pp_microbatches=``): the
engine places the pipeline (``Pipeline.shard`` or
``enable_pipeline_parallel``, with the JAX package's checks; under pipeline
parallelism every bucket is a multiple of dp × microbatches), or serves it
as it is when it is already placed on that mesh.  The JAX
engine drives every device from one process; here there is one process per
GPU.  Rank 0 takes the requests and runs the queue, the dispatch thread
(and the HTTP server); before each batch it broadcasts the batch (its
requests, contexts included, and its seed) to the other ranks, which run
``follow()``: the same batch in lockstep, until the stop message that
``close()`` sends.  The JAX engine's restoring of the active mesh on
``close()`` has no counterpart: the port keeps no process-wide mesh.

Not ported, with reasons: ``enable_persistent_cache`` (an XLA compile cache;
eager PyTorch has no program to keep).  An int8 pipeline
(``Pipeline.quantize``, before ``shard``) is served like any other.  An MoE pipeline is served like any other; its capacity counts
every row of a batch, the padded rows (copies of the first request)
included, so its images depend on the batch they ran in, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..parallel import collectives as C
from ..parallel import multihost
from ..utils import profiling


@dataclasses.dataclass
class GenerateRequest:
    """One text-to-image sample.  ``context`` is a (M, t5_dim) embedding
    (numpy or torch) or None (unconditional); ``text`` is encoded by the
    pipeline's tower at submit time."""
    context: object = None
    text: str | None = None
    timesteps: int = 16
    topk: int = 5
    temperature: float = 1.0
    guidance_scale: float | None = None
    cfg_warmup: float = 0.0
    seed: int | None = None

    def signature(self):
        ctx_len = None if self.context is None else int(self.context.shape[0])
        # guidance PRESENCE splits (cond-only vs CFG passes); the scale is a
        # per-sample operand, so mixed-scale requests coalesce
        return ('generate', ctx_len, self.timesteps, self.topk,
                self.guidance_scale is not None, self.cfg_warmup)


@dataclasses.dataclass
class ReconstructRequest:
    """Round-trip one image through the stage-1 tokenizer."""
    image: object = None  # (H, W, 3) float in [-1, 1]

    def signature(self):
        return ('reconstruct',) + tuple(np.shape(self.image))


@dataclasses.dataclass
class PaintRequest:
    """Inpaint (regenerate inside ``coord``) or outpaint (outside).
    ``coord`` is a pixel rect (x, y, h, w).  The rect and mode become a
    per-sample latent keep-mask, so requests with different rects and
    modes coalesce into one batch."""
    image: object = None
    coord: tuple = (0, 0, 0, 0)
    mode: str = 'inpaint'  # or 'outpaint'
    context: object = None
    text: str | None = None
    timesteps: int = 8
    topk: int = 1
    temperature: float = 0.0
    guidance_scale: float | None = None
    seed: int | None = None

    def signature(self):
        ctx_len = None if self.context is None else int(self.context.shape[0])
        return ('paint', ctx_len, self.timesteps, self.topk,
                self.guidance_scale is not None)


def _host_request(req):
    """``req`` with its tensors as host arrays, to broadcast."""
    fields = {}
    for f in ('context', 'image'):
        v = getattr(req, f, None)
        if isinstance(v, torch.Tensor):
            fields[f] = v.detach().float().cpu().numpy()
    return dataclasses.replace(req, **fields) if fields else req


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full."""


def _bucket(n, max_batch):
    return min(1 << max(0, math.ceil(math.log2(max(n, 1)))), max_batch)


def _nearest_rank(values, p):
    """The ``p`` percentile of sorted ``values`` by nearest rank (the
    ``ceil(p·n)``-th smallest); None for none."""
    if not values:
        return None
    return values[max(math.ceil(p * len(values)) - 1, 0)]


_MASK64 = (1 << 64) - 1


def _mix64(x):
    """splitmix64's output function: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seeds(seeds):
    """The requests' seeds, in batch order, folded into one 64-bit seed."""
    h = 0
    for s in seeds:
        h = _mix64(h ^ (int(s) & _MASK64))
    return h


class GenerationEngine:
    """Queue + dispatch thread around a ``Pipeline``.

    >>> eng = GenerationEngine(pipe, max_batch=8, max_wait_ms=5)
    >>> fut = eng.submit(GenerateRequest(timesteps=16))
    >>> img = fut.result()          # (H, W, 3) float32 in [-1, 1]
    """

    def __init__(self, pipeline, *, max_batch=16, max_wait_ms=20.0,
                 latency_window=512, max_queue=None, mesh=None,
                 sequence_parallel=False, pp_microbatches=None):
        self._min_bucket = 1
        block = getattr(pipeline.config, 'block', 'maskgit')
        if block != 'maskgit':
            raise NotImplementedError(
                f'GenerationEngine serves the MaskGIT stacks; the {block!r} '
                'stack (block diffusion over a KV cache) is not served: call '
                'Pipeline.generate')
        if mesh is not None:
            from ..parallel.mesh import check_mesh
            check_mesh(mesh, 'GenerationEngine')
        if mesh is None and (sequence_parallel or pp_microbatches):
            raise ValueError('sequence_parallel and pp_microbatches need '
                             'mesh= (parallel.mesh.make_mesh)')
        if pp_microbatches:
            if sequence_parallel:
                raise ValueError(
                    'sequence_parallel is not supported together with '
                    'pp_microbatches: the GPipe decode shards the batch, '
                    'not the token axis — serve the 512² variant either '
                    'sharded (mesh= + sequence_parallel=True) OR '
                    'pipelined, not both')
            # checked before enable_pipeline_parallel changes the pipeline
            self._min_bucket = mesh.size('data') * int(pp_microbatches)
            if int(max_batch) % self._min_bucket:
                raise ValueError(
                    f'max_batch {max_batch} must be divisible by dp × '
                    f'pp_microbatches = {self._min_bucket}')
        if mesh is not None and pipeline.mesh is not None:
            # a pipeline its owner already placed on this mesh is served
            # as it is
            if pipeline.mesh is not mesh:
                raise ValueError('the pipeline is placed on another mesh')
        elif pp_microbatches:
            pipeline.enable_pipeline_parallel(mesh, pp_microbatches)
        elif mesh is not None:
            pipeline.shard(mesh, sequence_parallel=sequence_parallel)
        self.mesh = mesh
        self.leader = mesh is None or multihost.is_main_process()
        self.pipeline = pipeline
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.max_queue = max_queue  # None = unbounded
        self._queue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._closed = False
        self._latencies = deque(maxlen=latency_window)
        self._counters = {'requests': 0, 'batches': 0, 'batched_requests': 0,
                          'errors': 0, 'padded_slots': 0, 'rejected': 0}
        self._seed_rng = np.random.default_rng()
        self._thread = None
        if self.leader:
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name='pm-serving-dispatch',
                                            daemon=True)
            self._thread.start()

    # -- public API --------------------------------------------------------

    def submit(self, request) -> Future:
        """Queue ``request``; the future's ``request_id`` is the ``id`` of
        its spans (``utils.profiling``).  Its latency in ``stats()`` runs
        from here, the tower's encode included."""
        t0 = time.monotonic()
        if not self.leader:
            raise RuntimeError('only rank 0 takes requests; the other ranks '
                               'run follow()')
        if self._closed:
            raise RuntimeError('engine is closed')
        rid = profiling.new_id()
        if isinstance(request, (GenerateRequest, PaintRequest)) \
                and request.text is not None and request.context is None:
            # encode text on the caller's thread; sampling stays batched
            with profiling.annotate('pm.serve.tower', id=rid):
                ctx = self.pipeline.embed_text([request.text])
            request = dataclasses.replace(request, context=ctx[0], text=None)
        fut = Future()
        fut.request_id = rid
        with self._lock:  # check + put under the lock: the bound holds
            if self.max_queue is not None \
                    and self._queue.qsize() >= self.max_queue:
                # backpressure: shed load, don't grow latency unboundedly
                self._counters['rejected'] += 1
                depth = self._queue.qsize()
            else:
                depth = None
                self._counters['requests'] += 1
                self._queue.put((request, fut, t0, time.monotonic()))
        if depth is not None:
            raise EngineOverloaded(
                f'queue depth {depth} >= max_queue {self.max_queue}')
        return fut

    def generate(self, **kw):
        """Synchronous convenience wrapper."""
        return self.submit(GenerateRequest(**kw)).result()

    def reconstruct(self, image):
        return self.submit(ReconstructRequest(image=np.asarray(image))).result()

    def reset_stats(self):
        """Zero counters and latencies (e.g. after a warm-up)."""
        with self._lock:
            self._latencies.clear()
            for k in self._counters:
                self._counters[k] = 0

    def stats(self):
        """The counters, the queue's depth, the mean batch occupancy and,
        over the last ``latency_window`` requests, nearest-rank percentiles
        of their latency (``submit`` to the batch's end: the tower's
        encode, the queue and the batch) and of their queue wait (enqueued
        to collected into a batch), in seconds (None before the first)."""
        with self._lock:
            recs = list(self._latencies)
            c = dict(self._counters)
        lat = sorted(r[0] for r in recs)
        wait = sorted(r[1] for r in recs)
        c.update(queue_depth=self._queue.qsize(),
                 latency_p50_s=_nearest_rank(lat, 0.50),
                 latency_p95_s=_nearest_rank(lat, 0.95),
                 queue_wait_p50_s=_nearest_rank(wait, 0.50),
                 queue_wait_p90_s=_nearest_rank(wait, 0.90),
                 mean_batch_occupancy=(c['batched_requests'] /
                                       c['batches'] if c['batches'] else None))
        return c

    def close(self, timeout=None):
        """Stop taking requests, run what was queued before, then stop the
        dispatch thread (and, under a mesh, the followers)."""
        self._closed = True
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join(timeout)

    def follow(self):
        """A rank other than 0: run the batches rank 0 broadcasts, in
        lockstep, until ``close()`` on rank 0 stops them.  Returns the
        number of batches run."""
        if self.leader:
            raise RuntimeError('rank 0 dispatches; follow() is for the other '
                               'ranks')
        device = self.pipeline.device
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        n = 0
        with torch.inference_mode():
            while True:
                msg = C.broadcast_object(None, src=0)
                if msg is None:
                    return n
                kind, reqs, seed = msg
                try:
                    self._run(kind, reqs, seed)
                except Exception:  # noqa: BLE001 — rank 0 reports it
                    pass
                n += 1

    def _announce(self, msg):
        if self.mesh is not None:
            C.broadcast_object(msg, src=0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch ----------------------------------------------------------

    def _dispatch_loop(self):
        device = self.pipeline.device
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        with torch.inference_mode():  # grad mode is per thread
            while True:
                item = self._queue.get()
                if item is None:
                    self._flush_all()
                    self._announce(None)
                    return
                group = self._collect_group(item)
                if group:
                    self._run_group(*group)

    def _collect_group(self, first):
        """Gather requests sharing ``first``'s signature until the bucket is
        full or ``max_wait`` has passed; incompatible arrivals are re-queued
        in their original order and picked up by the next group."""
        req, fut = first[:2]
        if fut.cancelled():
            return None
        sig = req.signature()
        group = [first]
        deadline = time.monotonic() + self.max_wait
        stash = []
        while len(group) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:  # close requested: finish this group first
                stash.append(None)  # re-queued AFTER earlier arrivals so
                break               # pre-close submissions still drain
            if item[1].cancelled():  # client gave up (e.g. 503'd fan-out)
                continue             # drop: don't burn a batch slot on it
            if item[0].signature() == sig:
                group.append(item)
            else:
                stash.append(item)
        for item in stash:  # preserve arrival order for the next group
            self._queue.put(item)
        return sig, group, time.monotonic()

    def _run(self, kind, reqs, seed):
        if kind == 'generate':
            return self._run_generate(reqs, seed)
        if kind == 'paint':
            return self._run_paint(reqs, seed)
        return self._run_reconstruct(reqs)

    def _run_group(self, sig, group, collected):
        """Run one collected group; ``collected``: when its collection
        ended (the end of its requests' queue wait)."""
        ids = [fut.request_id for _, fut, _, _ in group]
        batch = profiling.new_id()
        end_ns = time.time_ns()
        for (_, _, _, queued), rid in zip(group, ids):
            wait_ns = int((collected - queued) * 1e9)
            profiling.record('pm.serve.queue', end_ns - wait_ns, end_ns,
                             id=rid, batch=batch)
        try:
            reqs = [r for r, _, _, _ in group]
            with profiling.annotate(
                    'pm.serve.batch', id=batch, requests=ids,
                    padded=self._bucket_of(len(reqs)) - len(reqs)):
                seed = self._batch_seed(reqs)
                if self.mesh is not None:
                    self._announce((sig[0],
                                    [_host_request(r) for r in reqs], seed))
                outs = self._run(sig[0], reqs, seed)
            err = None
        except Exception as e:  # noqa: BLE001 — surfaced via futures
            outs, err = None, e
        now = time.monotonic()
        with self._lock:
            self._counters['batches'] += 1
            self._counters['batched_requests'] += len(group)
            if err is not None:
                self._counters['errors'] += len(group)
            for _, _, t0, queued in group:
                self._latencies.append((now - t0, collected - queued))
        for i, (_, fut, _, _) in enumerate(group):
            if fut.cancelled():  # client gave up while the batch ran
                continue
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(outs[i])

    def _padded(self, rows, bucket):
        """Stack ``rows`` on the pipeline's device as fp32 and pad to
        ``bucket`` with copies of the first; the pad rows' outputs are
        sliced off and never read."""
        x = torch.stack([torch.as_tensor(
            r if isinstance(r, torch.Tensor) else np.asarray(r, np.float32),
            dtype=torch.float32, device=self.pipeline.device) for r in rows])
        if bucket > len(rows):
            x = torch.cat([x, x[:1].expand(bucket - len(rows), *x.shape[1:])])
        return x

    def _bucket_of(self, n):
        """The bucket of ``n`` requests: a power of two capped at
        ``max_batch``, raised to a multiple of dp × microbatches under
        pipeline parallelism."""
        bucket = _bucket(n, self.max_batch)
        m = self._min_bucket
        if bucket % m:
            bucket = min((bucket + m - 1) // m * m, self.max_batch)
        return max(bucket, m)

    def _count_padding(self, n):
        """The batch's bucket (``_bucket_of``), its padded slots counted."""
        bucket = self._bucket_of(n)
        with self._lock:
            self._counters['padded_slots'] += bucket - n
        return bucket

    @staticmethod
    def _to_host(imgs, n):
        """The batch's first ``n`` images, to the host once."""
        imgs = imgs[:n].float().cpu().numpy()
        return [imgs[i] for i in range(n)]

    def _run_generate(self, reqs, seed):
        r0, n = reqs[0], len(reqs)
        bucket = self._count_padding(n)
        if r0.context is not None:
            text, num = self._padded([r.context for r in reqs], bucket), None
        else:
            text, num = None, bucket
        imgs = self.pipeline.generate(
            text=text, timesteps=r0.timesteps, topk=r0.topk,
            temperature=self._batch_temps(reqs, bucket),
            guidance_scale=self._batch_guidance(reqs, bucket),
            cfg_warmup=r0.cfg_warmup, num_samples=num, decode_steps='final',
            generator=self._generator(seed))[-1]
        return self._to_host(imgs, n)

    @staticmethod
    def _batch_temps(reqs, bucket):
        """Per-sample temperature vector (padded slots get 1.0), so
        mixed-temperature requests share a batch."""
        temps = np.ones((bucket,), np.float32)
        temps[:len(reqs)] = [float(r.temperature) for r in reqs]
        return temps

    @staticmethod
    def _batch_guidance(reqs, bucket):
        """Per-sample guidance vector, or None when the group is unguided
        (the signature splits on presence, so it is uniform in a group)."""
        if reqs[0].guidance_scale is None:
            return None
        g = np.ones((bucket,), np.float32)
        g[:len(reqs)] = [float(r.guidance_scale) for r in reqs]
        return g

    def _run_paint(self, reqs, seed):
        r0, n = reqs[0], len(reqs)
        bucket = self._count_padding(n)
        pipe = self.pipeline
        imgs = self._padded([r.image for r in reqs], bucket)
        ctx = None
        if r0.context is not None:
            ctx = self._padded([r.context for r in reqs], bucket)
        # rect + mode -> per-sample keep-mask rows; the pad rows copy request
        # 0's mask, regenerate inside its rect and are sliced off
        masks = torch.cat([pipe._rect_latent_mask(
            tuple(r.coord), inside=0 if r.mode == 'inpaint' else 1)
            for r in reqs])
        if bucket > n:
            masks = torch.cat([masks, masks[:1].expand(bucket - n, -1)])
        out = pipe.paint(imgs, masks, text=ctx, timesteps=r0.timesteps,
                         topk=r0.topk,
                         temperature=self._batch_temps(reqs, bucket),
                         guidance_scale=self._batch_guidance(reqs, bucket),
                         generator=self._generator(seed))
        return self._to_host(out, n)

    def _run_reconstruct(self, reqs):
        n = len(reqs)
        imgs = self._padded([r.image for r in reqs], self._count_padding(n))
        return self._to_host(self.pipeline.vqgan.reconstruct(imgs), n)

    def _batch_seed(self, reqs):
        """The batch's seed: the seeded requests' seeds folded together
        (reproducible only for an identical batch composition), else a
        fresh one."""
        seeds = [r.seed for r in reqs if getattr(r, 'seed', None) is not None]
        return (fold_seeds(seeds) if seeds
                else int(self._seed_rng.integers(2 ** 63)))

    def _generator(self, seed):
        """The batch's ``torch.Generator`` on the pipeline's device."""
        return torch.Generator(device=self.pipeline.device).manual_seed(seed)

    def _flush_all(self):
        """Fail any requests still queued at close time."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].set_exception(RuntimeError('engine closed'))
