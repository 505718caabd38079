"""The port's serving tier (``paintmind_tpu_torch.serving``) on the CPU.

The behavioural tests of ``tests/test_serving.py`` (batching, signatures,
padded slots, every endpoint and status code, backpressure, cancellation,
variations) run against the port's engine and HTTP server with a tiny
pipeline (``device='cpu'``).  Parity with the JAX engine on the same weights
(carried over by the weight bridge): ``/reconstruct`` within 1e-4 MAE; at
temperature 0 (the argmax of the top-k logits, no noise) generate and paint
give JAX's ids, and images within 1e-4 MAE.  An MoE pipeline is served
like a dense one.  What the port does not serve yet (int8, sharded and
pipeline-parallel placements) raises ``NotImplementedError`` naming its
ROADMAP queue item.
"""

import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paintmind_tpu.config as jcfg
from paintmind_tpu.models import pipeline as jpl
from paintmind_tpu.serving import GenerationEngine as JaxEngine
from paintmind_tpu.serving import GenerateRequest as JaxGenerateRequest
from paintmind_tpu.serving import PaintRequest as JaxPaintRequest
from paintmind_tpu.serving import ReconstructRequest as JaxReconstructRequest
from paintmind_tpu.utils.checkpoint import flatten_tree
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.convert.from_jax import load_jax_params
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.serving import (EngineOverloaded, GenerateRequest,
                                         GenerationEngine, PaintRequest,
                                         ReconstructRequest, make_server)
from paintmind_tpu_torch.serving.engine import _bucket, fold_seeds

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
jcfg.register_version('torch-serve-vqgan', SMALL_VQ)
tcfg.register_version('torch-serve-vqgan', SMALL_VQ)
PIPE_KW = dict(stage1='torch-serve-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, depth=1, dropout=0.0, t5_dim=48)
J_PIPE = jpl.PipelineConfig(vqc=jpl.vm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)
T_PIPE = tpl.PipelineConfig(vqc=tpl.vm.VQModelConfig.from_dict(SMALL_VQ),
                            **PIPE_KW)


def _mae(a, b):
    return float(np.mean(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


@pytest.fixture(scope='module')
def jpipe():
    return jpl.Pipeline(config=J_PIPE, stage1_pretrained=False,
                        text_encoder=None)


@pytest.fixture(scope='module')
def pipe(jpipe):
    p = tpl.Pipeline(T_PIPE, stage1_pretrained=False, text_encoder=None,
                     device='cpu')
    return load_jax_params(p, flatten_tree(jpipe.params))


class _Server:
    """make_server on an ephemeral port, served from a thread."""

    def __init__(self, engine):
        self.httpd = make_server(engine, port=0)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def conn(self, timeout=300):
        return http.client.HTTPConnection('127.0.0.1', self.port,
                                          timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


def _png_b64(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, 'RGB').save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def _post(conn, path, body):
    conn.request('POST', path, json.dumps(body),
                 {'Content-Type': 'application/json'})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _png_size(b64):
    from PIL import Image
    return Image.open(io.BytesIO(base64.b64decode(b64))).size


# ---------------------------------------------------------------------------
# batching semantics (tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_engine_batches_concurrent_requests(pipe):
    with GenerationEngine(pipe, max_batch=8, max_wait_ms=200) as eng:
        futs = [eng.submit(GenerateRequest(timesteps=2, topk=2, seed=i))
                for i in range(4)]
        outs = [f.result(timeout=120) for f in futs]
    for img in outs:
        assert isinstance(img, np.ndarray) and img.dtype == np.float32
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    stats = eng.stats()
    assert stats['requests'] == 4 and stats['errors'] == 0
    assert stats['batches'] <= 2
    assert stats['mean_batch_occupancy'] >= 2


def test_incompatible_signatures_run_separately(pipe):
    with GenerationEngine(pipe, max_batch=8, max_wait_ms=50) as eng:
        f1 = eng.submit(GenerateRequest(timesteps=2, topk=2))
        f2 = eng.submit(GenerateRequest(timesteps=3, topk=2))
        a, b = f1.result(timeout=120), f2.result(timeout=120)
    assert a.shape == b.shape == (32, 32, 3)
    assert eng.stats()['batches'] == 2
    assert GenerateRequest(timesteps=2).signature() != \
        GenerateRequest(timesteps=3).signature()
    # temperature and guidance scale are per-sample: same signature
    assert GenerateRequest(temperature=0.5, guidance_scale=2.0).signature() \
        == GenerateRequest(temperature=1.5, guidance_scale=7.0).signature()
    assert PaintRequest(coord=(0, 0, 8, 8), mode='inpaint').signature() == \
        PaintRequest(coord=(8, 8, 16, 16), mode='outpaint').signature()
    ctx = np.zeros((5, 48), np.float32)
    for req in (GenerateRequest(context=ctx, guidance_scale=2.0),
                PaintRequest(context=ctx), ReconstructRequest(
                    image=np.zeros((32, 32, 3), np.float32))):
        jreq = {GenerateRequest: JaxGenerateRequest, PaintRequest:
                JaxPaintRequest, ReconstructRequest: JaxReconstructRequest}[
                    type(req)](**vars(req))
        assert req.signature() == jreq.signature()


def test_padded_bucket_slots_are_sliced_away(pipe):
    assert [_bucket(n, 8) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 8]
    with GenerationEngine(pipe, max_batch=8, max_wait_ms=200) as eng:
        futs = [eng.submit(GenerateRequest(timesteps=2, topk=2))
                for _ in range(3)]
        outs = [f.result(timeout=120) for f in futs]
    assert len(outs) == 3
    # 3 requests pad to the 4-bucket: exactly one padded slot
    assert eng.stats()['padded_slots'] == 1


def test_conditioned_requests_batch_on_context(pipe):
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((5, 48)).astype(np.float32)
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=200) as eng:
        futs = [eng.submit(GenerateRequest(context=ctx, timesteps=2, topk=2,
                                           guidance_scale=2.0))
                for _ in range(2)]
        outs = [f.result(timeout=120) for f in futs]
    assert all(o.shape == (32, 32, 3) for o in outs)
    assert eng.stats()['batches'] == 1


def test_reconstruct_request(pipe):
    x = np.random.default_rng(1).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=10) as eng:
        rec = eng.submit(ReconstructRequest(image=x)).result(timeout=120)
        rec2 = eng.reconstruct(x)
    assert rec.shape == x.shape and np.isfinite(rec).all()
    np.testing.assert_array_equal(rec, rec2)


def test_closed_engine_rejects_submissions(pipe):
    eng = GenerationEngine(pipe, max_batch=2, max_wait_ms=1)
    eng.close()
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError):
        eng.submit(GenerateRequest(timesteps=2))


def test_close_drains_queued_requests(pipe):
    """Requests queued before close() still run; the dispatch thread ends."""
    eng = GenerationEngine(pipe, max_batch=2, max_wait_ms=1)
    futs = [eng.submit(GenerateRequest(timesteps=2, topk=2, seed=i))
            for i in range(5)]
    eng.close(timeout=300)
    assert not eng._thread.is_alive()
    assert all(f.result(timeout=1).shape == (32, 32, 3) for f in futs)


def test_http_server_endpoints(pipe):
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=10) as eng, \
            _Server(eng) as srv:
        conn = srv.conn()
        conn.request('GET', '/healthz')
        assert json.loads(conn.getresponse().read()) == {'ok': True}

        status, out = _post(conn, '/generate',
                            {'timesteps': 2, 'topk': 2, 'seed': 7})
        assert status == 200 and _png_size(out['image']) == (32, 32)

        # reconstruct an arbitrary-size image (transform resizes it)
        src = np.random.default_rng(2).integers(0, 255, (40, 50, 3),
                                                dtype=np.uint8)
        status, out = _post(conn, '/reconstruct', {'image': _png_b64(src)})
        assert status == 200 and _png_size(out['image']) == (32, 32)

        conn.request('GET', '/stats')
        stats = json.loads(conn.getresponse().read())
        assert stats['requests'] >= 2 and stats['errors'] == 0

        for method, path in (('POST', '/nope'), ('GET', '/nope')):
            conn.request(method, path, '{}' if method == 'POST' else None)
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 404
        for body in (b'{not json', json.dumps({}).encode()):
            path = '/generate' if body.startswith(b'{not') else '/reconstruct'
            conn.request('POST', path, body)
            resp = conn.getresponse()
            assert resp.status == 400 and 'error' in json.loads(resp.read())
        status, out = _post(conn, '/reconstruct', {'image': 'bm90IGFuIGltYWdl'})
        assert status == 400 and 'undecodable' in out['error']
        # a server-side fault (a context of the wrong width) is a 500
        status, out = _post(conn, '/generate', {
            'timesteps': 2, 'context': np.zeros((5, 7)).tolist()})
        assert status == 500 and 'error' in out


def test_paint_requests_batch_and_return_images(pipe):
    rng = np.random.default_rng(4)
    imgs = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=200) as eng:
        futs = [eng.submit(PaintRequest(image=imgs[i], coord=(8, 8, 16, 16),
                                        mode='inpaint', timesteps=2, topk=2))
                for i in range(3)]
        outs = [f.result(timeout=120) for f in futs]
    assert all(o.shape == (32, 32, 3) for o in outs)
    assert all(np.isfinite(o).all() for o in outs)
    assert eng.stats()['batches'] == 1
    assert eng.stats()['padded_slots'] == 1


def test_paint_requests_with_different_rects_coalesce(pipe):
    """Different rects and modes run as ONE batch."""
    rng = np.random.default_rng(7)
    imgs = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    reqs = [
        PaintRequest(image=imgs[0], coord=(0, 0, 16, 16), mode='inpaint',
                     timesteps=2, topk=2, seed=0),
        PaintRequest(image=imgs[1], coord=(8, 16, 16, 8), mode='inpaint',
                     timesteps=2, topk=2, seed=0),
        PaintRequest(image=imgs[2], coord=(8, 8, 16, 16), mode='outpaint',
                     timesteps=2, topk=2, seed=0),
    ]
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=300) as eng:
        outs = [f.result(timeout=120)
                for f in [eng.submit(r) for r in reqs]]
    assert eng.stats()['batches'] == 1
    assert all(o.shape == (32, 32, 3) for o in outs)


def test_batched_mixed_rect_paint_matches_single_requests(pipe):
    """One batched paint call with per-sample keep-masks equals per-sample
    calls (temperature 0 / top-k 1: deterministic and batch-independent)."""
    rng = np.random.default_rng(8)
    imgs = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    masks = torch.cat([pipe._rect_latent_mask((0, 0, 16, 16), inside=0),
                       pipe._rect_latent_mask((8, 8, 24, 16), inside=1)])
    batched = pipe.paint(imgs, masks, timesteps=2, topk=1, temperature=0.0,
                         generator=torch.Generator().manual_seed(11))
    for i in range(2):
        single = pipe.paint(imgs[i:i + 1], masks[i:i + 1], timesteps=2,
                            topk=1, temperature=0.0,
                            generator=torch.Generator().manual_seed(11))[0]
        np.testing.assert_allclose(batched[i].numpy(), single.numpy(),
                                   atol=1e-5)


def test_mixed_temperature_requests_coalesce(pipe):
    with GenerationEngine(pipe, max_batch=8, max_wait_ms=300) as eng:
        futs = [eng.submit(GenerateRequest(timesteps=2, topk=2, seed=i,
                                           temperature=t))
                for i, t in enumerate((0.5, 1.0, 1.7))]
        outs = [f.result(timeout=120) for f in futs]
    assert eng.stats()['batches'] == 1
    assert all(o.shape == (32, 32, 3) for o in outs)


def test_mixed_guidance_requests_coalesce(pipe):
    ctx = np.random.default_rng(11).standard_normal((5, 48)).astype(
        np.float32)
    with GenerationEngine(pipe, max_batch=8, max_wait_ms=300) as eng:
        futs = [eng.submit(GenerateRequest(context=ctx, timesteps=2, topk=2,
                                           seed=i, guidance_scale=g))
                for i, g in enumerate((1.5, 3.0, 7.5))]
        outs = [f.result(timeout=300) for f in futs]
    assert eng.stats()['batches'] == 1
    assert all(o.shape == (32, 32, 3) for o in outs)


def test_per_sample_guidance_vector_matches_scalar(pipe):
    """A uniform per-sample guidance vector equals the scalar path."""
    ctx = np.random.default_rng(12).standard_normal((2, 5, 48)).astype(
        np.float32)
    a = pipe.generate(text=ctx, timesteps=3, topk=2, guidance_scale=2.5,
                      decode_steps='final',
                      generator=torch.Generator().manual_seed(7))[-1]
    b = pipe.generate(text=ctx, timesteps=3, topk=2,
                      guidance_scale=np.array([2.5, 2.5], np.float32),
                      decode_steps='final',
                      generator=torch.Generator().manual_seed(7))[-1]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_per_sample_temperature_vector_matches_scalar(pipe):
    a = pipe.generate(num_samples=2, timesteps=3, topk=2, temperature=1.3,
                      decode_steps='final',
                      generator=torch.Generator().manual_seed(3))[-1]
    b = pipe.generate(num_samples=2, timesteps=3, topk=2,
                      temperature=np.array([1.3, 1.3], np.float32),
                      decode_steps='final',
                      generator=torch.Generator().manual_seed(3))[-1]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_seeded_batches_repeat_and_seeds_fold_in_order(pipe):
    """The same seeded batch twice gives the same images; the batch seed is
    a function of the seeds in batch order."""
    assert fold_seeds([1, 2]) == fold_seeds([1, 2]) != fold_seeds([2, 1])
    assert fold_seeds([-1]) != fold_seeds([1]) and fold_seeds([7]) < 2 ** 64

    def run():
        with GenerationEngine(pipe, max_batch=4, max_wait_ms=300) as eng:
            futs = [eng.submit(GenerateRequest(timesteps=2, topk=3, seed=5))
                    for _ in range(4)]
            outs = [f.result(timeout=120) for f in futs]
            assert eng.stats()['batches'] == 1
        return outs

    first, second = run(), run()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_http_paint_endpoint(pipe):
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=10) as eng, \
            _Server(eng) as srv:
        src = _png_b64(np.random.default_rng(5).integers(
            0, 255, (32, 32, 3), dtype=np.uint8))
        conn = srv.conn()
        status, out = _post(conn, '/outpaint', {
            'image': src, 'coord': [8, 8, 16, 16], 'timesteps': 2, 'topk': 2})
        assert status == 200 and _png_size(out['image']) == (32, 32)
        status, out = _post(conn, '/inpaint', {
            'image': src, 'coord': [0, 0, 16, 16], 'timesteps': 2,
            'prompt': None, 'seed': 3})
        assert status == 200
        bad_payloads = [
            {},                           # missing coord
            {'coord': [1, 2, 3]},         # wrong length
            {'coord': [0, 0, 999, 999]},  # out of bounds
            {'coord': ['a', 0, 1, 1]},    # not numbers
        ]
        for extra in bad_payloads:  # each -> 400, not an opaque 500
            status, out = _post(conn, '/inpaint', {'image': src, **extra})
            assert status == 400 and 'error' in out


def test_backpressure_rejects_when_queue_full(pipe):
    eng = GenerationEngine(pipe, max_batch=2, max_wait_ms=2000, max_queue=2)
    try:
        futs = []
        rejected = 0
        for _ in range(12):
            try:
                futs.append(eng.submit(GenerateRequest(timesteps=2, topk=2)))
            except EngineOverloaded:
                rejected += 1
        assert rejected >= 1
        assert eng.stats().get('rejected', 0) == rejected
        for f in futs:
            assert f.result(timeout=120).shape == (32, 32, 3)
    finally:
        eng.close()


def test_mixed_signature_concurrency_stress(pipe):
    """Many concurrent requests across four signatures from many threads:
    everything resolves, nothing deadlocks, per-signature batches form."""
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((5, 48)).astype(np.float32)
    img = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    reqs = []
    for i in range(24):
        kind = i % 4
        if kind == 0:
            reqs.append(GenerateRequest(timesteps=2, topk=2))
        elif kind == 1:
            reqs.append(GenerateRequest(timesteps=3, topk=2))
        elif kind == 2:
            reqs.append(GenerateRequest(context=ctx, timesteps=2, topk=2,
                                        guidance_scale=1.5))
        else:
            reqs.append(ReconstructRequest(image=img))
    from concurrent.futures import ThreadPoolExecutor
    with GenerationEngine(pipe, max_batch=8, max_wait_ms=100) as eng, \
            ThreadPoolExecutor(12) as pool:
        futs = list(pool.map(eng.submit, reqs))
        outs = [f.result(timeout=300) for f in futs]
    assert all(o.shape == (32, 32, 3) for o in outs)
    stats = eng.stats()
    assert stats['requests'] == 24 and stats['errors'] == 0
    assert stats['batches'] >= 4
    assert stats['mean_batch_occupancy'] > 1.5
    assert stats['latency_p50_s'] <= stats['latency_p95_s']


def test_http_503_when_overloaded(pipe):
    with GenerationEngine(pipe, max_batch=2, max_wait_ms=1,
                          max_queue=0) as eng, _Server(eng) as srv:
        status, out = _post(srv.conn(60), '/generate', {'timesteps': 2})
        assert status == 503 and out['retry'] is True


def test_cancelled_requests_do_not_wedge_the_engine(pipe):
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=400) as eng:
        fa = eng.submit(GenerateRequest(timesteps=2, topk=2, seed=0))
        fb = eng.submit(GenerateRequest(timesteps=2, topk=2, seed=1))
        won = fb.cancel()
        assert fa.result(timeout=120).shape == (32, 32, 3)
        if won:
            assert fb.cancelled()
        else:
            assert fb.result(timeout=120).shape == (32, 32, 3)
        fc = eng.submit(GenerateRequest(timesteps=2, topk=2, seed=2))
        assert fc.result(timeout=120).shape == (32, 32, 3)


def test_failed_batch_surfaces_through_its_futures(pipe):
    """A batch that raises fails its requests' futures and counts errors;
    the engine keeps serving."""
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=10) as eng:
        bad = eng.submit(GenerateRequest(context=np.zeros((5, 7), np.float32),
                                         timesteps=2))
        with pytest.raises(RuntimeError):
            bad.result(timeout=120)
        assert eng.stats()['errors'] == 1
        ok = eng.submit(GenerateRequest(timesteps=2, topk=2))
        assert ok.result(timeout=120).shape == (32, 32, 3)


def _imgvar_pipe():
    from paintmind_tpu_torch.models.clip import (CLIPImageEmbedder,
                                                 CLIPVisionConfig)
    tower = CLIPImageEmbedder(cfg=CLIPVisionConfig(
        image_size=28, patch_size=14, width=24, heads=2, layers=1), seed=5,
        device='cpu')
    cfg = tpl.PipelineConfig(**{**PIPE_KW, 't5': 'clip-img-l', 't5_dim': 24},
                             vqc=tpl.vm.VQModelConfig.from_dict(SMALL_VQ))
    return tpl.Pipeline(cfg, stage1_pretrained=False, text_encoder=tower,
                        device='cpu')


def test_http_variations_endpoint():
    """An image-conditioned pipeline serves /variations; the N samples ride
    the normal dynamic batching and come back distinct."""
    from PIL import Image
    with GenerationEngine(_imgvar_pipe(), max_batch=8,
                          max_wait_ms=100) as eng, _Server(eng) as srv:
        src = _png_b64(np.random.default_rng(3).integers(
            0, 255, (32, 32, 3), dtype=np.uint8))
        conn = srv.conn()
        status, out = _post(conn, '/variations', {
            'image': src, 'num': 3, 'timesteps': 2, 'topk': 2})
        assert status == 200 and len(out['images']) == 3
        arrs = [np.asarray(Image.open(io.BytesIO(base64.b64decode(b))))
                for b in out['images']]
        assert all(a.shape == (32, 32, 3) for a in arrs)
        assert not np.array_equal(arrs[0], arrs[1])
        assert eng.stats()['mean_batch_occupancy'] > 1.5
        for body in ({}, {'image': src, 'num': 0}, {'image': src, 'num': 'x'}):
            status, out = _post(conn, '/variations', body)
            assert status == 400


def test_http_variations_rejects_text_pipeline(pipe):
    with GenerationEngine(pipe, max_batch=2, max_wait_ms=10) as eng, \
            _Server(eng) as srv:
        status, out = _post(srv.conn(60), '/variations', {
            'image': _png_b64(np.zeros((32, 32, 3), np.uint8))})
        assert status == 400 and 'tower' in out['error']


def test_prompts_encode_on_the_submitting_thread(pipe):
    """A prompt is encoded by the pipeline's tower at submit(); requests
    with the same context length batch together."""
    calls = []

    class Tower:
        def __call__(self, texts):
            calls.append(threading.current_thread().name)
            return torch.ones(len(texts), 5, 48) * len(texts[0])

    p = tpl.Pipeline(T_PIPE, stage1_pretrained=False, text_encoder=Tower(),
                     device='cpu')
    with GenerationEngine(p, max_batch=4, max_wait_ms=200) as eng, \
            _Server(eng) as srv:
        status, out = _post(srv.conn(), '/generate', {
            'prompt': 'a red fox', 'timesteps': 2, 'topk': 2})
        assert status == 200
        futs = [eng.submit(GenerateRequest(text=t, timesteps=2, topk=2))
                for t in ('a', 'bb')]
        assert all(f.result(timeout=120).shape == (32, 32, 3) for f in futs)
    assert len(calls) == 3 and 'pm-serving-dispatch' not in calls
    assert eng.stats()['batches'] == 2


# ---------------------------------------------------------------------------
# parity with the JAX engine on the same weights
# ---------------------------------------------------------------------------

def test_reconstruct_matches_jax_engine(jpipe, pipe):
    x = np.random.default_rng(21).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    with JaxEngine(jpipe, max_batch=4, max_wait_ms=200) as jeng:
        want = [f.result(timeout=300) for f in
                [jeng.submit(JaxReconstructRequest(image=i)) for i in x]]
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=200) as eng:
        got = [f.result(timeout=300) for f in
               [eng.submit(ReconstructRequest(image=i)) for i in x]]
    for a, b in zip(got, want):
        assert _mae(a, b) <= 1e-4


@pytest.mark.parametrize('guidance', [None, 2.5])
def test_generate_at_temperature_zero_matches_jax(jpipe, pipe, guidance):
    """Temperature 0 keeps the argmax of the top-k logits (the noise cannot
    move it): the port's ids equal JAX's ``generate_ids``, and the engine's
    images equal JAX's ``Pipeline.generate`` within 1e-4 MAE."""
    rng = np.random.default_rng(22)
    ctx = rng.standard_normal((3, 5, 48)).astype(np.float32)
    kw = dict(timesteps=3, topk=3, temperature=0.0, guidance_scale=guidance)
    want = np.asarray(jpipe.generate(text=jnp.asarray(ctx), decode_steps='final',
                                     key=jax.random.PRNGKey(0), **kw)[-1])
    init = np.full((3, J_PIPE.num_tokens), J_PIPE.mask_token_id, np.int32)
    jids, _ = jpl.generate_ids(jpipe.params, jax.random.PRNGKey(1),
                               jnp.asarray(init), jnp.asarray(ctx),
                               cfg=J_PIPE, backend='xla', **kw)
    tids, _ = tpl.generate_ids(pipe, torch.from_numpy(init),
                               torch.from_numpy(ctx), cfg=T_PIPE,
                               generator=torch.Generator().manual_seed(1), **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=300) as eng:
        futs = [eng.submit(GenerateRequest(context=c, **kw)) for c in ctx]
        got = [f.result(timeout=300) for f in futs]
        assert eng.stats()['batches'] == 1
    for i in range(3):
        assert _mae(got[i], want[i]) <= 1e-4


def test_paint_at_temperature_zero_matches_jax(jpipe, pipe):
    """Inpaint and outpaint requests with different rects through the
    engine at temperature 0: JAX's ``Pipeline.paint`` ids (through
    ``generate_ids`` with the clamped re-mask) and images within 1e-4 MAE."""
    rng = np.random.default_rng(23)
    imgs = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    coords, modes = [(0, 0, 16, 16), (8, 8, 24, 16)], ['inpaint', 'outpaint']
    keep = np.concatenate([np.asarray(jpipe._rect_latent_mask(
        c, inside=0 if m == 'inpaint' else 1)) for c, m in zip(coords, modes)])
    kw = dict(timesteps=2, topk=1, temperature=0.0)
    want = np.asarray(jpipe.paint(imgs, keep, key=jax.random.PRNGKey(2), **kw))
    _, ids, _ = pipe.to_latent(imgs)
    init = torch.where(torch.from_numpy(keep).bool(), ids,
                       torch.tensor(T_PIPE.mask_token_id, dtype=ids.dtype))
    jids, _ = jpl.generate_ids(jpipe.params, jax.random.PRNGKey(3),
                               jnp.asarray(init.numpy()), None, cfg=J_PIPE,
                               backend='xla', clamp_remask=True, **kw)
    tids, _ = tpl.generate_ids(pipe, init, None, cfg=T_PIPE, clamp_remask=True,
                               **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    with GenerationEngine(pipe, max_batch=2, max_wait_ms=300) as eng:
        futs = [eng.submit(PaintRequest(image=imgs[i], coord=coords[i],
                                        mode=modes[i], **kw))
                for i in range(2)]
        got = [f.result(timeout=300) for f in futs]
        assert eng.stats()['batches'] == 1
    for i in range(2):
        assert _mae(got[i], want[i]) <= 1e-4


# ---------------------------------------------------------------------------
# MoE, and what the port does not serve yet
# ---------------------------------------------------------------------------

def test_engine_serves_quantized_pipeline(jpipe):
    """An int8 (w8a8) pipeline behind the engine, as the JAX package serves
    one: at temperature 0 the engine's images equal a quantized JAX
    pipeline's ``generate`` within 1e-4 MAE."""
    qj = jpl.Pipeline(config=J_PIPE, stage1_pretrained=False,
                      text_encoder=None)
    qj.params = jpipe.params
    qj.vqgan.params = jpipe.params['vqgan']
    qj.quantize('w8a8', min_dim=16)
    qt = load_jax_params(
        tpl.Pipeline(T_PIPE, stage1_pretrained=False, text_encoder=None,
                     device='cpu'), flatten_tree(jpipe.params))
    qt.quantize('w8a8', min_dim=16)
    ctx = np.random.default_rng(23).standard_normal((3, 5, 48)).astype(
        np.float32)
    kw = dict(timesteps=3, topk=3, temperature=0.0)
    want = np.asarray(qj.generate(text=jnp.asarray(ctx), decode_steps='final',
                                  key=jax.random.PRNGKey(0), **kw)[-1])
    with GenerationEngine(qt, max_batch=4, max_wait_ms=300) as eng:
        futs = [eng.submit(GenerateRequest(context=c, **kw)) for c in ctx]
        got = [f.result(timeout=300) for f in futs]
        assert eng.stats()['batches'] == 1
    for i in range(3):
        assert _mae(got[i], want[i]) <= 1e-4


def test_engine_serves_moe_pipeline():
    """An MoE pipeline (E = 4, top-2, capacity factor 1.25: the capacity
    counts every row of the batch) behind the engine: three seeded requests
    run as one batch of 4, padded with a copy of the first, and their
    images equal ``Pipeline.generate`` of that padded batch on the engine's
    folded seed, bit for bit."""
    moe = jpl.PipelineConfig(vqc=J_PIPE.vqc, num_experts=4, **PIPE_KW)
    jparams = jax.jit(lambda k: jpl.init_pipeline(k, moe))(
        jax.random.PRNGKey(3))
    pipe = load_jax_params(
        tpl.Pipeline(tpl.PipelineConfig(vqc=T_PIPE.vqc, num_experts=4,
                                        **PIPE_KW),
                     stage1_pretrained=False, text_encoder=None, device='cpu'),
        flatten_tree(jparams))
    ctx = np.random.default_rng(24).standard_normal((3, 5, 48)).astype(
        np.float32)
    seeds = [7, 8, 9]
    kw = dict(timesteps=3, topk=3)
    with GenerationEngine(pipe, max_batch=4, max_wait_ms=300) as eng:
        futs = [eng.submit(GenerateRequest(context=ctx[i], seed=seeds[i],
                                           guidance_scale=2.0, **kw))
                for i in range(3)]
        got = [f.result(timeout=300) for f in futs]
        stats = eng.stats()
    assert stats['batches'] == 1 and stats['padded_slots'] == 1
    # the engine's batch: the pad row copies request 0's context and takes
    # temperature and guidance 1.0
    direct = pipe.generate(
        text=torch.from_numpy(np.concatenate([ctx, ctx[:1]])),
        temperature=np.ones(4, np.float32),
        guidance_scale=np.asarray([2.0, 2.0, 2.0, 1.0], np.float32),
        decode_steps='final',
        generator=torch.Generator().manual_seed(fold_seeds(seeds)), **kw)[-1]
    for i in range(3):
        np.testing.assert_array_equal(got[i], direct[i].numpy())


def test_engine_refuses_sharded_pipeline(pipe):
    """A sharded engine needs a mesh (the two-rank engine is held in
    tests/test_torch_multiprocess.py): another object, or
    ``sequence_parallel`` without a mesh, is refused before the pipeline
    changes."""
    with pytest.raises(TypeError, match='parallel.mesh.Mesh'):
        GenerationEngine(pipe, max_batch=4, mesh=object())
    with pytest.raises(ValueError, match='need mesh='):
        GenerationEngine(pipe, max_batch=4, sequence_parallel=True)
    assert pipe.mesh is None and pipe.transformer.tp is None


def test_engine_refuses_pipeline_parallel_pipeline(pipe):
    """The JAX engine's guards (``engine.py:119-140``): pp_microbatches
    without a mesh, and the pipeline's own refusals."""
    with pytest.raises(ValueError, match='need mesh='):
        GenerationEngine(pipe, max_batch=4, pp_microbatches=2)
    with pytest.raises(TypeError, match='parallel.mesh.Mesh'):
        GenerationEngine(pipe, max_batch=4, mesh=object(), pp_microbatches=2)
    with pytest.raises(TypeError, match='parallel.mesh.Mesh'):
        pipe.enable_pipeline_parallel(object(), 2)
    with pytest.raises(ValueError, match='needs a mesh'):
        pipe.enable_pipeline_parallel(None, 2)
