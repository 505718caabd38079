"""The rest of the JAX package's public API in the port, and collectives
over one rank, on the CPU.

The facade (``paintmind_tpu.__all__`` and ``__version__``), the trainers'
``finalize_checkpoints``, ``reconstruction`` from an http URL (``urllib``
monkeypatched: nothing reaches the network; held against the JAX package's
figure on the same weights), and, in a one-rank gloo process group of this
process: every function of ``parallel/collectives.py`` returns its input
without calling ``torch.distributed`` and is still counted; a one-stage
GPipe sends nothing; ``shard(mesh).quantize(mode)`` equals
``quantize(mode)`` bit for bit; ``disable_pipeline_parallel`` leaves an
unstaged pipeline as it is.  The multi-rank forms of the last two run in
the gloo jobs of ``tests/test_torch_parallel.py`` and
``tests/test_torch_pipeline_parallel.py``.  Inputs come from numpy seeds;
each tolerance is stated in its test.
"""

import io
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

import paintmind_tpu as pm
import paintmind_tpu.config as jcfg
import paintmind_tpu.reconstruct as jrec
from paintmind_tpu.utils.checkpoint import flatten_tree
import paintmind_tpu_torch as pt
from paintmind_tpu_torch import config as tcfg
from paintmind_tpu_torch.convert.from_jax import load_jax_params
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.nn.transformer import stack_apply
from paintmind_tpu_torch.parallel import collectives as C
from paintmind_tpu_torch.parallel import mesh as pmesh
from paintmind_tpu_torch.parallel.pipeline_parallel import pp_stack_apply

from _torch_dist import free_port

SMALL_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 32, 'patch_size': 8, 'dim': 32, 'depth': 2,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
# reconstruction() takes 256² images: 256 tokens of patch 16, one layer
DEMO_VQ = {
    'n_embed': 64, 'embed_dim': 8, 'beta': 0.25,
    'enc': {'image_size': 256, 'patch_size': 16, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'in_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
    'dec': {'image_size': 256, 'patch_size': 16, 'dim': 32, 'depth': 1,
            'num_head': 2, 'mlp_dim': 64, 'out_channels': 3, 'dim_head': 16,
            'dropout': 0.0},
}
for _reg in (jcfg.register_version, tcfg.register_version):
    _reg('torch-api-vqgan', SMALL_VQ)
    _reg('torch-api-demo-vqgan', DEMO_VQ)
PIPE_KW = dict(stage1='torch-api-vqgan', t5='t5-l', dim=32, dim_head=16,
               mlp_dim=64, num_head=2, depth=2, dropout=0.0, t5_dim=48)


def make_pipe(seed=0):
    cfg = tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(SMALL_VQ),
                             **PIPE_KW)
    return tpl.Pipeline(cfg, stage1_pretrained=False, text_encoder=None,
                        device='cpu', seed=seed)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def test_facade_covers_the_jax_package():
    """Every name of ``paintmind_tpu.__all__`` is in the port's ``__all__``
    and resolves to an object of the port (``ver2cfg``: the port's version
    table; ``__version__``: below); the port keeps its own extras."""
    assert set(pm.__all__) <= set(pt.__all__)
    for name in set(pm.__all__) - {'__version__', 'ver2cfg'}:
        obj = getattr(pt, name)
        assert obj.__module__.startswith('paintmind_tpu_torch'), (name, obj)
    assert pt.ver2cfg is tcfg.ver2cfg
    for extra in ('optim', 'register_version', 'set_attention_backend'):
        assert extra in pt.__all__ and hasattr(pt, extra)
    assert pt.Pipeline is tpl.Pipeline and pt.VQModel is tvm.VQModel


def test_version_matches_the_jax_package():
    from paintmind_tpu.version import __version__ as jver
    from paintmind_tpu_torch.version import __version__ as tver
    assert pt.__version__ == tver == jver == pm.__version__


def test_stage_transforms_match_the_jax_package():
    """The exported transforms give the JAX package's pixels (eval mode,
    both stages) on a seeded image."""
    arr = np.random.default_rng(4).integers(0, 255, (300, 260, 3), np.uint8)
    img = Image.fromarray(arr, 'RGB')
    for name in ('stage1_transform', 'stage2_transform'):
        want = getattr(pm, name)(is_train=False)(img)
        np.testing.assert_array_equal(getattr(pt, name)(is_train=False)(img),
                                      want)


# ---------------------------------------------------------------------------
# finalize_checkpoints
# ---------------------------------------------------------------------------

class _Images:
    def __init__(self, n, with_caption):
        self.n, self.with_caption = n, with_caption

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.random.default_rng(i).uniform(
            -1, 1, (32, 32, 3)).astype(np.float32)
        return (img, f'caption {i}') if self.with_caption else img


def _embedder(captions):
    return np.stack([np.random.default_rng(len(c)).standard_normal(
        (5, 48)).astype(np.float32) for c in captions])


def _trainer(kind, tmp_path):
    args = dict(num_epoch=1, valid_size=4, lr=1e-3, warmup_steps=1,
                batch_size=4, num_workers=1, mixed_precision='no',
                save_every=100, sample_every=100, result_folder=str(tmp_path),
                log_dir=str(tmp_path / 'log'), seed=3)
    if kind == 'vqgan':
        vq = tvm.VQModel(SMALL_VQ, device='cpu')
        return pt.VQGANTrainer(vq, _Images(12, False),
                               perceptual_weights='none', **args)
    return pt.PaintMindTrainer(make_pipe(), _Images(12, True),
                               text_embedder=_embedder, **args)


@pytest.mark.parametrize('kind', ['vqgan', 'paintmind'])
def test_finalize_checkpoints(kind, tmp_path, monkeypatch):
    """``finalize_checkpoints()`` exists on both trainers, returns None
    after ``save()`` with the state file and the model export complete
    (both load), and ``train()`` calls it at its end, after its last save,
    as the JAX package's trainers do."""
    t = _trainer(kind, tmp_path)
    path = t.save()
    assert t.finalize_checkpoints() is None
    state = torch.load(path, map_location='cpu', weights_only=False)
    assert state['step'] == 0
    prefix = 'vit_vq' if kind == 'vqgan' else 'paintmind'
    with np.load(tmp_path / 'models' / f'{prefix}_step_0.npz') as z:
        assert len(z.files) > 0
    calls = []
    save = type(t).save

    def recorded_save(self):
        calls.append('save')
        return save(self)

    monkeypatch.setattr(type(t), 'save', recorded_save)
    monkeypatch.setattr(type(t), 'finalize_checkpoints',
                        lambda self: calls.append('finalize'))
    t.train()
    assert calls == ['save', 'finalize']


# ---------------------------------------------------------------------------
# reconstruction from a URL
# ---------------------------------------------------------------------------

def test_reconstruction_from_url_matches_pil_and_jax(monkeypatch):
    """``reconstruction('http://…')`` fetches with ``urllib.request.urlopen``
    (monkeypatched to serve PNG bytes) and gives the figure of the PIL
    image bit for bit; the JAX package's ``reconstruction`` of the same URL
    on the same weights gives the same figure within one level of 255."""
    arr = np.random.default_rng(6).integers(0, 255, (280, 300, 3), np.uint8)
    png = io.BytesIO()
    Image.fromarray(arr, 'RGB').save(png, format='PNG')
    asked = []

    class _Response(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    def urlopen(url, *args, **kwargs):
        asked.append(url)
        return _Response(png.getvalue())

    monkeypatch.setattr(urllib.request, 'urlopen', urlopen)
    jmodel = pm.create_model(arch='vqgan', version='torch-api-demo-vqgan',
                             pretrained=False)
    tmodel = load_jax_params(tvm.VQModel(DEMO_VQ, device='cpu'),
                             flatten_tree(jmodel.params))
    url = 'http://example.invalid/image.png'
    fig = np.asarray(pt.reconstruction(url, model=tmodel))
    assert asked == [url]
    want = np.asarray(pt.reconstruction(Image.open(io.BytesIO(png.getvalue())),
                                        model=tmodel))
    np.testing.assert_array_equal(fig, want)
    jfig = np.asarray(jrec.reconstruction(url, model=jmodel))
    assert asked == [url, url] and fig.shape == jfig.shape == (256, 512, 3)
    assert np.abs(fig.astype(int) - jfig.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# one rank: the collectives are the identity and issue nothing
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def one_rank():
    """A gloo process group of this one process and its (1, 1) mesh."""
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        yield pmesh.make_mesh(device='cpu')
    finally:
        dist.destroy_process_group()


_DATA_CALLS = ('all_reduce', 'all_gather', 'all_gather_into_tensor',
            'reduce_scatter_tensor', 'broadcast', 'broadcast_object_list',
            'all_gather_object', 'batch_isend_irecv', 'isend', 'irecv',
            'send', 'recv', 'barrier')


@pytest.fixture
def no_issue(one_rank, monkeypatch):
    """Every ``torch.distributed`` call that would carry data raises."""
    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f'torch.distributed.{name} was called')
        return call

    for name in _DATA_CALLS:
        monkeypatch.setattr(dist, name, refuse(name))
    C.reset_counts()
    return one_rank


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize('fn', ['all_reduce', 'all_gather', 'reduce_scatter',
                                'local_slice'])
def test_one_rank_tensor_collective_is_identity(no_issue, fn):
    """Over the one-rank 'model' group each function returns its input
    itself (``all_reduce`` in place, as over more ranks), calls no
    ``torch.distributed`` function and is counted in ``counts`` and
    ``elided`` (``local_slice`` is not a collective: not counted)."""
    group = no_issue.group('model')
    x = _x(2, 6, 4)
    keep = x.clone()
    out = (getattr(C, fn)(x, group, 1) if fn != 'all_reduce'
           else C.all_reduce(x, group))
    assert out is x and torch.equal(x, keep)
    kind = {'local_slice': None}.get(fn, fn)
    want = {k: int(k == kind) for k in C.KINDS}
    assert C.snapshot() == want and C.elided == want


def test_one_rank_object_collectives(no_issue):
    """``broadcast_object`` returns the object itself and
    ``all_gather_object`` a list of it, over the default group and the
    mesh's; both counted and elided; ``send_recv`` with nothing to send is
    not counted."""
    obj = {'a': [1, 2]}
    for group in (None, no_issue.group('data')):
        assert C.broadcast_object(obj, 0, group) is obj
        got = C.all_gather_object(obj, group)
        assert got == [obj] and got[0] is obj
    C.send_recv()
    want = dict.fromkeys(C.KINDS, 0)
    want.update(broadcast=2, all_gather=2)
    assert C.snapshot() == want and C.elided == want
    C.reset_counts()
    assert C.snapshot() == C.elided == dict.fromkeys(C.KINDS, 0)


PAIRS = {'copy_to': 0, 'reduce_from': 1, 'gather_seq': 1, 'scatter_seq': 1,
         'gather_split': 1, 'sum_replicated': 1}  # forward collectives


@pytest.mark.parametrize('grad', [True, False])
@pytest.mark.parametrize('fn', sorted(PAIRS))
def test_one_rank_autograd_pairs_are_identity(no_issue, fn, grad):
    """The autograd pairs over one rank: the forward gives the input's
    values, the backward the cotangent's, bit for bit, with no
    ``torch.distributed`` call; their collectives are counted.  Where no
    gradient can flow (``grad=False``: under ``torch.no_grad``) a pair is
    its forward alone, with no autograd node, and counts the forward's
    collectives only."""
    group = no_issue.group('model')
    x = _x(2, 6, 4).requires_grad_(True)
    g = _x(2, 6, 4, seed=1)
    args = (x, group) if fn in ('copy_to', 'reduce_from',
                                'sum_replicated') else (x, group, 1)
    if not grad:
        with torch.no_grad():
            y = getattr(C, fn)(*args)
        assert y is x
        assert sum(C.counts.values()) == sum(C.elided.values()) == PAIRS[fn]
        return
    y = getattr(C, fn)(*args)
    assert torch.equal(y, x) and y.grad_fn is not None
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, g)
    assert sum(C.counts.values()) == sum(C.elided.values()) >= 1


def test_one_stage_gpipe_sends_nothing(no_issue):
    """``pp_stack_apply`` at one stage and two microbatches sends nothing
    (no ``send_recv``) and issues nothing; its output and gradients equal
    the plain stack's within 1e-6 relative (fp32: the microbatches'
    products have other row counts)."""
    layers = make_pipe().transformer.layers.requires_grad_(True)
    x, ctx, w = _x(4, 8, 32), _x(4, 5, 32, seed=1), _x(4, 8, 32, seed=2)
    runs = {}
    for name, run in (('plain', lambda: stack_apply(layers, x, ctx)),
                      ('pp', lambda: pp_stack_apply(layers, x, ctx,
                                                    mesh=no_issue,
                                                    microbatches=2))):
        layers.zero_grad(set_to_none=True)
        out = run()
        (out * w).sum().backward()
        runs[name] = [out.detach()] + [p.grad.clone()
                                       for p in layers.parameters()]
    for a, b in zip(runs['pp'], runs['plain']):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert C.counts['send_recv'] == 0 and C.counts['all_reduce'] >= 1
    assert C.elided == C.snapshot()


@pytest.mark.parametrize('mode', ['w8a8', 'w8'])
def test_one_rank_shard_then_quantize(no_issue, mode):
    """At world size 1: ``shard(mesh).quantize(mode)`` holds
    ``quantize(mode)``'s tensors bit for bit, carved as
    ``quantize(mode).shard(mesh)`` carves them, and its logits are equal;
    a second ``quantize`` still raises."""
    x, ctx = _x(2, 16, 8), _x(2, 5, 48, seed=1)
    whole = make_pipe().quantize(mode, min_dim=16)
    after = make_pipe().shard(no_issue).quantize(mode, min_dim=16)
    before = make_pipe().quantize(mode, min_dim=16).shard(no_issue)
    want = whole.state_dict()
    for other in (after, before):
        got = other.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    def carves(p):
        return {k: v[:2] for k, v in pmesh._carves(p).items()}

    assert carves(after) == carves(before) and carves(after)
    with torch.no_grad():
        assert torch.equal(after.transformer(x, ctx), whole.transformer(x, ctx))
    with pytest.raises(RuntimeError, match='already quantized'):
        after.quantize(mode)


def test_disable_pipeline_parallel_on_unstaged_is_noop(one_rank):
    """As in the JAX package: ``disable_pipeline_parallel`` on an unstaged
    pipeline returns it unchanged, sharded or not (one rank cannot stage:
    that needs two)."""
    pipe = make_pipe()
    layers = pipe.transformer.layers
    assert pipe.disable_pipeline_parallel() is pipe
    assert pipe.transformer.layers is layers and pipe.mesh is None
    pipe.shard(one_rank)
    assert pipe.disable_pipeline_parallel() is pipe and pipe.mesh is one_rank
    with pytest.raises(ValueError, match='>= 2 stages'):
        pipe.enable_pipeline_parallel(one_rank, 2)
