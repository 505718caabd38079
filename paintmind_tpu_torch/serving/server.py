"""Minimal JSON-over-HTTP front end for :class:`GenerationEngine`
(``paintmind_tpu/serving/server.py``): the same endpoints, bodies and status
codes (400 malformed request, 404 unknown path, 500 server fault, 503 queue
full).

Stdlib-only (``http.server`` + threads) so the serving tier adds no
dependencies.  One engine instance per process; request handling threads
encode prompts with the pipeline's tower and block on engine futures while
the single dispatch thread drives the card.

Endpoints:
  GET  /healthz       -> {"ok": true}
  GET  /stats         -> engine counters, latency and queue-wait
                         percentiles (``GenerationEngine.stats``)
  POST /generate      -> {"prompt"?: str, "context"?: [[...]], "timesteps"?,
                          "topk"?, "temperature"?, "guidance_scale"?,
                          "cfg_warmup"?, "seed"?}
                         returns {"image": <base64 PNG>}
  POST /reconstruct   -> {"image": <base64 PNG>}   (any RGB image; it is
                         resized/cropped with the stage-1 eval transform)
                         returns {"image": <base64 PNG>}
  POST /inpaint       -> {"image": <base64>, "coord": [x, y, h, w],
  POST /outpaint          "prompt"?, "timesteps"?, "topk"?, ...}
                         regenerate inside (inpaint) / outside (outpaint)
                         the pixel rect; returns {"image": <base64 PNG>}
  POST /variations    -> {"image": <base64>, "num"?: int, "timesteps"?, ...}
                         N generations conditioned on the reference image
                         (requires an image-conditioning tower, e.g. the
                         'paintmindv1-imgvar' pipeline); the N requests ride
                         the normal dynamic batching; returns
                         {"images": [<base64 PNG>, ...]}
"""

from __future__ import annotations

import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils import profiling
from .engine import (EngineOverloaded, GenerateRequest, GenerationEngine,
                     PaintRequest, ReconstructRequest)


def _img_to_png_b64(img):
    """(H, W, 3) float in [-1, 1] -> base64 PNG string."""
    from PIL import Image
    arr = np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255)
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode('ascii')


def _reply_png(fut):
    """The image of an engine future as base64 PNG, encoded in a
    ``pm.serve.png`` span of its request."""
    img = fut.result()
    with profiling.annotate('pm.serve.png', id=fut.request_id):
        return _img_to_png_b64(img)


class ClientError(ValueError):
    """Request-validation failure → HTTP 400.  Handlers raise this ONLY
    for malformed input; any other exception (including ValueError from
    inside the pipeline) is a server-side 500 so internal defects are
    never misreported as client errors."""


def _png_b64_to_img(b64, image_size):
    """base64 image -> (H, W, 3) float in [-1, 1] at the model resolution."""
    from PIL import Image
    from ..utils.transform import stage1_transform
    try:
        pil = Image.open(io.BytesIO(base64.b64decode(b64))).convert('RGB')
    except Exception as e:
        raise ClientError(f'undecodable image payload: {e}') from e
    return np.asarray(
        stage1_transform(img_size=image_size, is_train=False)(pil))


class _Handler(BaseHTTPRequestHandler):
    engine: GenerationEngine = None  # set by make_server
    defaults: dict = None
    protocol_version = 'HTTP/1.1'

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == '/healthz':
            return self._reply(200, {'ok': True})
        if self.path == '/stats':
            return self._reply(200, self.engine.stats())
        return self._reply(404, {'error': f'unknown path {self.path}'})

    def do_POST(self):
        try:
            length = int(self.headers.get('Content-Length', 0))
            req = json.loads(self.rfile.read(length) or b'{}')
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply(400, {'error': f'bad request body: {e}'})
        try:
            if self.path == '/generate':
                return self._reply(200, self._generate(req))
            if self.path == '/reconstruct':
                return self._reply(200, self._reconstruct(req))
            if self.path in ('/inpaint', '/outpaint'):
                return self._reply(200, self._paint(req, self.path[1:]))
            if self.path == '/variations':
                return self._reply(200, self._variations(req))
        except EngineOverloaded as e:
            return self._reply(503, {'error': str(e), 'retry': True})
        except ClientError as e:  # request validation → client error
            return self._reply(400, {'error': str(e)})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            return self._reply(500, {'error': f'{type(e).__name__}: {e}'})
        return self._reply(404, {'error': f'unknown path {self.path}'})

    def _generate(self, req):
        kw = dict(self.defaults)
        for k in ('timesteps', 'topk', 'temperature', 'guidance_scale',
                  'cfg_warmup', 'seed'):
            if k in req:
                kw[k] = req[k]
        context = req.get('context')
        if context is not None:
            context = np.asarray(context, np.float32)
        return {'image': _reply_png(self.engine.submit(GenerateRequest(
            text=req.get('prompt'), context=context, **kw)))}

    def _paint(self, req, mode):
        for k in ('image', 'coord'):
            if k not in req:
                raise ClientError(f"missing '{k}' "
                                 "(image: base64; coord: [x, y, h, w])")
        coord = req['coord']
        size = self.engine.pipeline.image_size
        if (not isinstance(coord, (list, tuple)) or len(coord) != 4
                or not all(isinstance(v, (int, float)) for v in coord)):
            raise ClientError(
                f'coord must be a 4-number [x, y, h, w] rect, got {coord!r}')
        x0, y0, h, w = coord
        if not (0 <= x0 <= size and 0 <= y0 <= size
                and 0 <= h <= size and 0 <= w <= size):
            raise ClientError(f'coord {coord!r} outside the {size}px image')
        x = _png_b64_to_img(req['image'], self.engine.pipeline.image_size)
        context = req.get('context')
        if context is not None:
            context = np.asarray(context, np.float32)
        kw = {k: req[k] for k in ('timesteps', 'topk', 'temperature',
                                  'guidance_scale', 'seed') if k in req}
        return {'image': _reply_png(self.engine.submit(PaintRequest(
            image=x, coord=tuple(req['coord']), mode=mode,
            text=req.get('prompt'), context=context, **kw)))}

    def _variations(self, req):
        if 'image' not in req:
            raise ClientError("missing 'image' (base64 PNG/JPEG reference)")
        pipe = self.engine.pipeline
        tower_ok = pipe.config.t5.startswith('clip-img')
        if not tower_ok:
            from ..models.clip import CLIPImageEmbedder
            tower_ok = isinstance(pipe.text_model, CLIPImageEmbedder)
        if not tower_ok:
            raise ClientError(
                "this pipeline's conditioning tower does not take images — "
                "serve an image-conditioned pipeline (e.g. "
                "'paintmindv1-imgvar') for /variations")
        try:
            n = int(req.get('num', 4))
        except (TypeError, ValueError):
            raise ClientError(f"num must be an int, got {req['num']!r}")
        if not 1 <= n <= 16:
            raise ClientError(f'num must be in [1, 16], got {n}')
        x = _png_b64_to_img(req['image'], pipe.image_size)
        # embed once on this handler thread; the N samples share the context
        # and coalesce in the dispatch batch (distinct batch rows draw
        # distinct gumbel noise, so they ARE variations)
        ctx = pipe.embed_text(x[None])[0]
        kw = dict(self.defaults)
        for k in ('timesteps', 'topk', 'temperature', 'guidance_scale',
                  'cfg_warmup', 'seed'):
            if k in req:
                kw[k] = req[k]
        seed = kw.pop('seed', None)
        futs = []
        try:
            for i in range(n):
                futs.append(self.engine.submit(GenerateRequest(
                    context=ctx,
                    seed=None if seed is None else int(seed) + i, **kw)))
        except Exception:
            # overload partway through the fan-out: drop what we queued —
            # orphaned requests would burn full sampler batches whose
            # results nobody reads
            for f in futs:
                f.cancel()
            raise
        return {'images': [_reply_png(f) for f in futs]}

    def _reconstruct(self, req):
        if 'image' not in req:
            raise ClientError("missing 'image' (base64 PNG/JPEG)")
        x = _png_b64_to_img(req['image'], self.engine.pipeline.image_size)
        return {'image': _reply_png(self.engine.submit(
            ReconstructRequest(image=x)))}


def make_server(engine, host='127.0.0.1', port=8000, defaults=None):
    """Build (without starting) a ThreadingHTTPServer bound to ``engine``."""
    handler = type('Handler', (_Handler,), {
        'engine': engine,
        'defaults': {'timesteps': 16, 'topk': 5, **(defaults or {})},
    })

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 128  # a burst of clients connecting at once

        def handle_error(self, request, client_address):
            # client hangups (ConnectionResetError at teardown) are routine
            import sys
            exc = sys.exc_info()[1]  # sys.exception() needs 3.11+
            if not isinstance(exc, (ConnectionError, BrokenPipeError)):
                super().handle_error(request, client_address)

    return _Server((host, port), handler)


def serve(pipeline, host='127.0.0.1', port=8000, *, max_batch=16,
          max_wait_ms=20.0, defaults=None, max_queue=None, **engine_kw):
    """Blocking entry point: wrap ``pipeline`` in an engine and serve.
    ``max_queue`` bounds the request queue (full → HTTP 503);
    ``engine_kw``: the engine's ``mesh``, ``sequence_parallel`` and
    ``pp_microbatches``.  Under a mesh only rank 0 serves HTTP; the other
    ranks follow its batches until it stops."""
    with GenerationEngine(pipeline, max_batch=max_batch,
                          max_wait_ms=max_wait_ms,
                          max_queue=max_queue, **engine_kw) as engine:
        if not engine.leader:
            engine.follow()
            return
        httpd = make_server(engine, host, port, defaults)
        print(f'serving on http://{host}:{httpd.server_address[1]} '
              f'(max_batch={max_batch}, max_wait={max_wait_ms}ms)')
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
