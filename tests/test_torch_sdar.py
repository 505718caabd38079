"""SDAR-30B-A3B's decoder stack as the ``sdar-30b-a3b`` stage-2 transformer
(``models/sdar_transformer.py``, ``models/pipeline.generate_blocks``) on the
CPU at a tiny width (dim 64, 4 query and 2 KV heads of 16, 128 experts of
16, top-8, 3 layers, a 4 x 4 grid in blocks of 4), against the benchmark's
plain reference ``benchmark/reference/sdar.py`` (the JAX package has no
such model).  The shared parts (K1's GQA and cache view through its tiled
emulation, K5's dropless 128-expert layer through its plain and tiled
versions) are held to their plain versions and to the reference.

Tolerances: fp32 throughout; the port against the reference 1e-4 max abs
on logits of magnitude ~3 and K/V of ~1 (measured ~2e-6: the same
products in another order), the tiled emulations against the plain
versions 1e-5 in fp32 and one bf16 step (8e-3 relative) in bf16."""

import json
import math
import os
import subprocess
import sys
import tempfile

import pytest
import torch

import paintmind_tpu_torch as pt
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.nn import moe as tmoe
from paintmind_tpu_torch.nn.attention import CachedAttention
from paintmind_tpu_torch.nn.core import RMSNorm, rope_tables
from paintmind_tpu_torch.ops import flash_attention as fa
from paintmind_tpu_torch.ops import moe_experts as me
from paintmind_tpu_torch.ops.rope import norm_rope, norm_rope_plain
from paintmind_tpu_torch.utils import profiling

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'benchmark')
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
from reference import sdar as rs  # noqa: E402

TINY_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
TINY = dict(pt.ver2cfg['sdar-30b-a3b'], stage1='torch-sdar-vqgan', dim=64,
            dim_head=16, num_head=4, kv_heads=2, depth=3, num_experts=128,
            num_selected=8, expert_hidden=16, block_len=4, block_steps=4)
pt.register_version('torch-sdar-vqgan', TINY_VQ)
pt.register_version('torch-sdar', TINY)
B, M = 2, 5          # rows, prompt length
MASK = TINY_VQ['n_embed']


def _pipe(seed=0):
    pipe = pt.create_model('pipeline', 'torch-sdar', pretrained=False,
                           device='cpu', text_encoder=None, seed=seed)
    g = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():  # norm gains and biases away from their inits
        for n, p in pipe.transformer.named_parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return pipe


def _context(seed=1):
    return torch.randn(B, M, 1024, generator=torch.Generator().manual_seed(seed))


def _run(pipe, steps=None, seed=3):
    """generate_blocks with every pass's input tokens, every step's logits
    and the cache kept."""
    tr = pipe.transformer
    passes, logits = [], []
    hooks = [tr.register_forward_pre_hook(lambda m, a: passes.append(a[0])),
             tr.to_logits.register_forward_hook(
                 lambda m, a, out: logits.append(out))]
    try:
        ids = tpl.generate_blocks(pipe, _context(), cfg=pipe.config, topk=3,
                                  steps=steps,
                                  generator=torch.Generator().manual_seed(seed))
    finally:
        for h in hooks:
            h.remove()
    cache = tr.cache(B, M + pipe.num_tokens, dtype=torch.float32, device='cpu')
    return ids, passes, logits, cache


def _weights(pipe):
    return {n: t.float() for n, t in pipe.state_dict().items()}


def test_generate_logits_match_reference_every_block_and_step():
    """Each step's logits (the block's tokens over the cache) equal the
    reference's full forward of [prompt; finished blocks; the block at that
    step] under the explicit block-causal mask; ``Pipeline.generate`` runs
    the same passes and decodes the final ids."""
    pipe = _pipe()
    ids, passes, logits, _ = _run(pipe)
    steps, n = TINY['block_steps'], TINY['block_len']
    blocks = pipe.num_tokens // n
    assert len(passes) == blocks * (steps + 1) and len(logits) == blocks * steps
    W = _weights(pipe)
    for j in range(blocks):
        done = [passes[i * (steps + 1) + steps] for i in range(j)]
        seqs = [torch.cat(done + [passes[j * (steps + 1) + s]], dim=1)
                for s in range(steps)]
        want, _ = rs.forward(W, TINY, _context(), seqs, n)
        for s in range(steps):
            got = logits[j * steps + s]
            assert got.shape == (B, n, TINY_VQ['n_embed'])
            torch.testing.assert_close(got, want[s], rtol=0, atol=1e-4)
    imgs = pipe.generate(_context(), topk=3,
                         generator=torch.Generator().manual_seed(3))
    assert len(imgs) == 1 and imgs[0].shape == (B, 32, 32, 3)
    dec = pipe.vqgan.decode_from_indice(ids)
    torch.testing.assert_close(imgs[0], dec)


def test_committed_cache_equals_reference_kv():
    """The KV cache a call leaves (the commit passes' K/V of every block,
    the prompt's from the prefill) equals the reference's post-RoPE K and
    V of the call's final sequence at every layer."""
    pipe = _pipe(seed=4)
    _, passes, _, cache = _run(pipe)
    steps = TINY['block_steps']
    final = torch.cat(passes[steps::steps + 1], dim=1)
    _, kv = rs.forward(_weights(pipe), TINY, _context(), [final],
                       TINY['block_len'], kv_layers=range(TINY['depth']))
    for i, (k, v) in enumerate(cache):
        assert k.shape == (B, M + pipe.num_tokens, 2, 16)
        torch.testing.assert_close(k, kv[i][0][0], rtol=0, atol=1e-4)
        torch.testing.assert_close(v, kv[i][0][1], rtol=0, atol=1e-4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h,hk,d', [(8, 2, 128), (6, 3, 64), (4, 4, 32)])
def test_gqa_cache_view_tiled_matches_repeated_plain(dtype, h, hk, d):
    """K1's tiled emulation on grouped K/V read through a view [:, :M] of a
    longer cache (rows past M NaN) equals the plain version on the K/V
    repeated per query head; the CPU wrapper takes the view as well."""
    g = torch.Generator().manual_seed(h * d)
    b, n, m, rows = 2, 70, 141, 200
    q = torch.randn(b, n, h, d, generator=g).to(dtype)
    kc = torch.full((b, rows, hk, d), float('nan'), dtype=dtype)
    vc = torch.full_like(kc, float('nan'))
    kc[:, :m] = torch.randn(b, m, hk, d, generator=g).to(dtype)
    vc[:, :m] = torch.randn(b, m, hk, d, generator=g).to(dtype)
    k, v = kc[:, :m], vc[:, :m]
    assert not k.is_contiguous()
    rep = [t.repeat_interleave(h // hk, dim=2) for t in (k, v)]
    want = fa.flash_attention_plain(q, *rep, d ** -0.5)
    got = fa.flash_attention_tiled(q, k, v, d ** -0.5)[0]
    tol = dict(rtol=0, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=8e-3, atol=8e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(fa.flash_attention(q, k, v, d ** -0.5), want)


def _moe_layer(seed, e=128, k=8, d=32, hidden=16):
    g = torch.Generator().manual_seed(seed)
    layer = tmoe.MoESwiGLU(d, None, e, num_selected=k, capacity_factor=None,
                           expert_hidden=hidden, expert_bias=False)
    with torch.no_grad():
        layer.router.weight.normal_(0, 0.5, generator=g)
        for lin in (layer.experts.w12, layer.experts.w3):
            lin.init_weights_(g)
    assert layer.experts.w12.bias is None and layer.experts.w3.bias is None
    return layer


@pytest.mark.parametrize('t', [37, 300])
def test_dropless_routing_128_experts(t):
    """No capacity: every one of the k·T assignments is kept (cap = T) and
    packed; the packed plain path, the padded path and the reference's
    routed FFN agree; K5's tile emulation equals its plain version on the
    packed rows, bias-free."""
    layer = _moe_layer(t)
    x = torch.randn(t, 32, generator=torch.Generator().manual_seed(t + 1))
    with torch.no_grad():
        _, _, gate, idx, pos, keep, cap = tmoe.route(layer, x, 8, None)
    assert cap == t and bool(keep.all())
    off, row, xp = me.dispatch(x, idx, pos, keep, cap, 128)
    assert int(off[-1]) == 8 * t and bool((row >= 0).all())
    w = (layer.experts.w12.weight, None, layer.experts.w3.weight, None)
    plain = me.grouped_swiglu_plain(xp, off, *w)
    torch.testing.assert_close(me.grouped_swiglu_tiled(xp, off, *w)[:8 * t],
                               plain[:8 * t], rtol=0, atol=1e-5)
    with torch.no_grad():
        packed, aux = tmoe.moe_swiglu(layer, x, 8, None, 'gather')
    with torch.enable_grad():
        padded, _ = tmoe.moe_swiglu(layer, x, 8, None, 'gather')
    assert float(aux['dropped']) == 0.0
    W = {'ffnet.router.weight': layer.router.weight,
         'ffnet.experts.w12.weight': layer.experts.w12.weight,
         'ffnet.experts.w3.weight': layer.experts.w3.weight}
    want = rs.routed(W, 'ffnet.', x, {'num_selected': 8})
    torch.testing.assert_close(packed, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(padded.detach(), want, rtol=0, atol=1e-5)


def test_capacity_routing_unchanged_by_dropless_option():
    """A capacity factor still drops past ``max(1, int(T k / E cf + 0.999))``
    exactly as before; None is the only dropless value."""
    assert tmoe.capacity(100, 2, 8, 1.25) == 32
    assert tmoe.capacity(100, 8, 128, None) == 100
    layer = _moe_layer(5, e=8, k=2)
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        *_, keep, cap = tmoe.route(layer, x, 2, 0.5)
    assert cap == 8 and not bool(keep.all())


def test_rmsnorm_qknorm_rope_formulas():
    """RMSNorm is x / sqrt(mean x² + eps) · w; QK-norm is that over each
    head's dims of q and k; RoPE rotates each pair (x_i, x_{i + D/2}) by
    pos · theta^(-2i/D), so that q·k depends only on the positions'
    difference."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=g)
    norm = RMSNorm(64, 1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.randn(64, generator=g))
    want = x / torch.sqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * norm.weight
    torch.testing.assert_close(norm(x), want)
    torch.testing.assert_close(norm(x.bfloat16()), want.bfloat16())
    d, theta = 16, 1e6
    pos = torch.arange(7)
    cos, sin = rope_tables(pos, d, theta)
    q = torch.randn(2, 7, 3, d, generator=g)
    q = q * torch.rsqrt(q.pow(2).mean(-1, keepdim=True))  # the norm's fixed point

    def rope(x, cos, sin):  # the rotary pass with a unit gain and no eps
        return norm_rope_plain(x, cos, sin, torch.ones(x.shape[-1]), 0.0)

    got = rope(q, cos, sin)
    ang = pos[:, None].double() * theta ** (-2 * torch.arange(d // 2).double() / d)
    z = torch.complex(q[..., :d // 2].double(), q[..., d // 2:].double())
    z = z * torch.polar(torch.ones_like(ang), ang)[None, :, None]
    torch.testing.assert_close(got, torch.cat([z.real, z.imag], -1).float())
    torch.testing.assert_close(got, rs.rope(q, pos, theta))
    a, b = q[0, 0, 0], q[0, 1, 1]
    dots = [float(rope(a.expand(1, 1, 1, d), *rope_tables([p], d, theta))
                  .flatten() @ rope(b.expand(1, 1, 1, d),
                                    *rope_tables([p + 3], d, theta)).flatten())
            for p in (0, 2, 5)]
    assert max(dots) - min(dots) < 1e-4
    attn = CachedAttention(32, heads=4, kv_heads=2, dim_head=8)
    with torch.no_grad():
        attn.q_norm.weight.copy_(torch.randn(8, generator=g))
    h = torch.randn(2, 5, 4, 8, generator=g)
    w = attn.q_norm.weight
    torch.testing.assert_close(attn.q_norm(h), rs.rms_norm(h, w, 1e-6))
    # QK-norm inside the rotary pass (K6's plain version): norm, then rope
    c8, s8 = rope_tables(range(5), 8, theta)
    torch.testing.assert_close(
        norm_rope(h, c8, s8, w, 1e-6),
        rs.rope(rs.rms_norm(h, w, 1e-6), torch.arange(5), theta))


@pytest.mark.parametrize('steps', [4, 2])
def test_block_schedule_unmasks_per_step_and_freezes_blocks(steps):
    """Each step unmasks block_len / steps of the block's positions and
    keeps what earlier steps unmasked (the scaled-down 16 of 64 a step);
    the first step of a block sees it all masked; a commit pass holds no
    mask, and the final ids hold every block as its commit wrote it."""
    pipe = _pipe(seed=2)
    ids, passes, _, _ = _run(pipe, steps=steps)
    table = torch.cat([pipe.vqgan.quantize.codebook, pipe.mask_token])
    n = TINY['block_len']
    per = n // steps

    def to_ids(tok):
        return torch.cdist(tok.reshape(-1, tok.shape[-1]), table).argmin(
            -1).reshape(tok.shape[:2])

    for j in range(pipe.num_tokens // n):
        seq = [to_ids(t) for t in passes[j * (steps + 1):(j + 1) * (steps + 1)]]
        assert bool((seq[0] == MASK).all())
        for s in range(steps):
            held = seq[s] != MASK
            assert bool((seq[s + 1][held] == seq[s][held]).all())
            assert ((seq[s + 1] == MASK).sum(1) == n - per * (s + 1)).all()
        assert torch.equal(ids[:, j * n:(j + 1) * n].long(), seq[-1])
    assert not bool((ids == MASK).any())


def test_reference_imports_nothing_of_the_port():
    code = (f'import sys; sys.path.insert(0, {BENCH!r})\n'
            'from reference import sdar\n'
            'print(sorted(m for m in sys.modules if m.startswith("paintmind")))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_benchmark_files_resolve():
    """The cell, its configuration (the catalog's numbers under their keys,
    only the vocabulary reduced), its traffic, generator, check and readers
    resolve through the harness."""
    import harness
    cell = harness.resolve('sdar_blk64_b64')
    c = cell.config
    assert c['reduced'] == ['vocab_size'] and c['vocab_size'] == 8192
    p = c['pipeline']
    assert (c['hidden_size'], c['num_hidden_layers'], c['num_attention_heads'],
            c['num_key_value_heads'], c['head_dim'], c['num_experts'],
            c['num_experts_per_tok'], c['moe_intermediate_size']) == (
        p['dim'], p['depth'], p['num_head'], p['kv_heads'], p['dim_head'],
        p['num_experts'], p['num_selected'], p['expert_hidden']) == (
        2048, 48, 32, 4, 128, 128, 8, 768)
    assert cell.traffic['generator'] == 'block_generate'
    assert os.path.exists(os.path.join(BENCH, 'generators',
                                       'block_generate.py'))
    names = {m['name'] for m in cell.per_layer()}
    assert {'mfu.block', 'moe_roofline.block', 'attn_roofline.block',
            'moe_expert_ms_per_pass.block', 'rope_roofline.block',
            'sampler_ms_per_step.block', 'moe_move_ms_per_pass.block',
            'idle_share.batch'} <= names
    for m in names:
        assert os.path.exists(os.path.join(BENCH, 'layer_metrics', m + '.py'))
    assert set(cell.check['limits']) == {
        'struct_errors', 'logit_gap', 'token_miss_share', 'sample_kl',
        'cache_err', 'image_err_max'}


def _tiny_cell(root):
    """The cell at the tiny width in fp32, as files and BENCHMARK.json
    entries in a copy of the benchmark under ``root``."""
    import shutil
    import harness
    base = os.path.join(root, 'benchmark')
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        '__pycache__', '.cache', 'tests'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    with open(os.path.join(base, 'configs', 'sdar-30b-a3b-t2i.json')) as f:
        c = json.load(f)
    c['stage1'] = TINY_VQ
    c['pipeline'].update({k: TINY[k] for k in (
        'dim', 'dim_head', 'num_head', 'kv_heads', 'depth', 'expert_hidden',
        'block_len')}, stage1='torch-sdar-vqgan')
    c.update(name='tiny-sdar', compute_dtype='float32')
    with open(os.path.join(base, 'configs', 'tiny-sdar.json'), 'w') as f:
        json.dump(c, f)
    with open(os.path.join(base, 'traffic', 't2i_blocks_b64.json')) as f:
        tr = dict(json.load(f), batch=4, context_len=M)
    with open(os.path.join(base, 'traffic', 'tiny_blocks.json'), 'w') as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(base, 'cells', 'sdar_blk64_b64.json'),
                os.path.join(base, 'cells', 'tiny_sdar.json'))
    bench['configs'].append({'name': 'tiny-sdar', 'source': 'a test',
                             'file': 'benchmark/configs/tiny-sdar.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny_sdar', 'config': 'tiny-sdar',
                               'traffic': 'tiny_blocks', 'chips': 1,
                               'why': 'a test'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'sdar_blk64_b64' in m.get('workloads', ()):
            m['workloads'].append('tiny_sdar')
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    return harness.resolve('tiny_sdar', root=root, base=base)


@pytest.mark.parametrize('control', [None, 'reference'])
def test_tiny_cell_runs_through_the_harness(control):
    """The cell's generator and check at the tiny width on the CPU: sound
    runs read inside every limit; with the fp8 reference as the control,
    its readings are reported and it breaks at least one limit."""
    import time

    import harness
    with tempfile.TemporaryDirectory() as root:
        cell = _tiny_cell(root)
        res, numbers = harness.run_cell(cell, 2**31 + 77, 0.2, 0, 'cpu',
                                        time.time(), control=control)
    sound = {n: v for n, v, _ in numbers if '.' not in n}
    assert set(sound) == set(cell.check['limits'])
    assert all(v <= cell.check['limits'][n] for n, v in sound.items()), sound
    assert res['metrics']['images_per_s']['value'] > 0
    if control is None:
        assert res['correct']
    else:
        ctl = {n: v for n, v, lim in numbers if n.endswith('.control')}
        assert len(ctl) == 5
        assert any(v > cell.check['limits'][n.split('.')[0]]
                   for n, v in ctl.items()), ctl


def test_sdar_paths_refused_where_unsupported():
    pipe = _pipe()
    with pytest.raises(ValueError, match='unguided'):
        pipe.generate(_context(), guidance_scale=3.0)
    with pytest.raises(ValueError, match='prompt'):
        pipe.generate(None)
    with pytest.raises(NotImplementedError):
        pipe.sample(torch.zeros(1, 16, dtype=torch.int32), 0.5)
    with pytest.raises(NotImplementedError):
        tpl.pipeline_loss(pipe, torch.zeros(1, 32, 32, 3), None, 0.5)
    from paintmind_tpu_torch.serving.engine import GenerationEngine
    with pytest.raises(NotImplementedError, match='not served'):
        GenerationEngine(pipe)
    q = torch.randn(1, 4, 4, 8, requires_grad=True)
    kv = torch.randn(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match='grouped'):
        fa.flash_attention(q, kv, kv, 0.3)


def test_counters_of_a_call():
    """While recording, each K1 call adds 4 B H N M D operations and its
    K/V bytes, and each routed call the experts that got rows."""
    pipe = _pipe()
    profiling.reset()
    with profiling.recording():
        _run(pipe)
    c = profiling.snapshot()['counters']
    profiling.reset()
    n, steps, depth = TINY['block_len'], TINY['block_steps'], TINY['depth']
    blocks = pipe.num_tokens // n
    keys = [M] + [M + n * (j + 1) for j in range(blocks)
                  for _ in range(steps + 1)]
    rows = [M] + [n] * (blocks * (steps + 1))
    ops = sum(4 * B * 4 * r * m * 16 for r, m in zip(rows, keys)) * depth
    assert c['pm.attn.ops'] == ops
    assert c['pm.attn.kv_bytes'] == sum(2 * B * m * 2 * 16 * 4
                                        for m in keys) * depth
    assert int(c['pm.moe.rows']) == 8 * B * sum(rows) * depth
    assert 0 < int(c['pm.moe.experts_hit']) <= 128 * len(rows) * depth
    assert math.isclose(float(c['pm.moe.kept']),
                        float(c['pm.moe.assignments']))


def test_tally_of_a_pass_equals_its_counters():
    """What a graph's capture counts (``profiling.tally`` around the
    stack's pass, spans off inside) equals what the same pass counts while
    recording, and ``recount`` adds it to the counters only while they
    record."""
    pipe = _pipe()
    tr = pipe.transformer
    g = torch.Generator().manual_seed(3)
    ctx = torch.randn(B, M, 1024, generator=g)
    cache = tr.cache(B, M + pipe.num_tokens, dtype=torch.float32,
                     device='cpu')
    x = tr.context_proj(ctx)
    profiling.reset()
    with torch.no_grad():
        with profiling.recording():
            tr._layers(x, cache, 0, None)
        want = profiling.snapshot()
        profiling.reset()
        with profiling.recording(), profiling.tally() as counts:
            tr._layers(x, cache, 0, None)
    assert profiling.snapshot() == {'spans': {}, 'counters': {}}
    assert set(counts) == set(want['counters'])
    for name, value in counts.items():
        assert float(value) == want['counters'][name], name
    profiling.recount(counts)
    assert profiling.snapshot()['counters'] == {}
    with profiling.recording():
        profiling.recount(counts)
        profiling.recount(counts)
    got = profiling.snapshot()['counters']
    profiling.reset()
    assert got == {n: 2 * v for n, v in want['counters'].items()}


def _reader(name):
    import harness
    return harness.import_file(os.path.join(BENCH, 'layer_metrics',
                                            name + '.py'),
                               'test_reader_' + name.replace('.', '_'))


def test_block_readers_on_a_traced_window():
    """The cell's K5 readers on a traced window made up by hand (a card's
    kernel rows; the launches and counters that the graphs' replays add):
    K5's kernel time a pass, the routing's named kernels a pass, and K5's
    roofline from the counted rows and experts hit; nothing read off a
    card, when K5's launches or the rows disagree with the traffic's
    shapes, or when one of the routing's kernels is missing."""
    import flops_blocks
    import harness
    from peaks import for_device
    cell = harness.resolve('sdar_blk64_b64')
    cfg, tr = cell.config, cell.traffic
    calls, depth = 2, cfg['pipeline']['depth']
    passes = flops_blocks.passes(cfg, tr)
    plan = [(calls * n, t * 8) for n, t in flops_blocks.routed_calls(cfg, tr)]
    routed = sum(n for n, _ in plan)
    assert routed == calls * passes * depth
    kernels = {'moe_expert_gemm<144, 1>': 3.0, 'moe_expert_gemm<256, 0>': 2.0,
               'nvjet_other': 1.0}
    move = _reader('moe_move_ms_per_pass.block')
    kernels.update({key + '<...>': 0.25 for key in move.KERNELS})
    gpu = {'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3'}

    def ctx(launches=routed, device=gpu):
        return harness.ReaderContext(
            cell=cell, trace={'kernels': kernels, 'window': 10.0,
                              'busy_s': 9.0},
            counters={'calls': calls, 'launches': {'K5': launches}},
            device=device)

    expert = _reader('moe_expert_ms_per_pass.block')
    assert math.isclose(expert.read(ctx()), 1e3 * 5.0 / (calls * passes))
    assert expert.read(ctx(launches=routed - 1)) is None
    assert expert.read(ctx(device={'platform': 'cpu', 'kind': 'cpu'})) is None
    assert math.isclose(move.read(ctx()),
                        1e3 * 0.25 * len(move.KERNELS) / (calls * passes))
    assert move.read(ctx(launches=routed - 1)) is None
    kernels.pop(move.KERNELS[0] + '<...>')
    assert move.read(ctx()) is None
    roof = _reader('moe_roofline.block')
    profiling.reset()
    with profiling.recording():
        profiling.count('pm.moe.rows', sum(n * r for n, r in plan))
        profiling.count('pm.moe.experts_hit', torch.tensor(128 * routed))
    peaks = for_device(gpu['kind'])
    bound = sum(n * flops_blocks.expert_bound_seconds(cfg, r, 128.0, peaks)
                for n, r in plan)
    try:
        assert math.isclose(roof.read(ctx()), 100.0 * bound / 5.0)
        assert roof.read(ctx(launches=routed + 1)) is None
        with profiling.recording():
            profiling.count('pm.moe.rows', 1)
        assert roof.read(ctx()) is None
    finally:
        profiling.reset()
