"""The jobs of the port's multi-process tests, one process per rank:

    python _torch_dist_jobs.py <job> <rank> <world> <port> <dir> <model>

reads ``<dir>/in.pt``, joins a gloo process group of ``world`` ranks on
``127.0.0.1:<port>``, builds a (world/model, model) mesh, runs the job and
writes ``<dir>/out_<rank>.pt``.  The jobs import the port only (no JAX): the
tests compute the JAX references in their own process.

``python _torch_dist_jobs.py torchrun-train <argv...>`` (under ``torchrun``)
registers the test's tiny versions and runs
``paintmind_tpu_torch.scripts.train_paintmind``.
"""

import os
import sys

import numpy as np
import torch

import paintmind_tpu_torch as pt
from paintmind_tpu_torch.convert.from_jax import load_jax_params
from paintmind_tpu_torch.models import pipeline as tpl
from paintmind_tpu_torch.models import vqmodel as tvm
from paintmind_tpu_torch.parallel import collectives as C
from paintmind_tpu_torch.parallel import mesh as pmesh
from paintmind_tpu_torch.parallel import multihost


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(t):
    return t.detach().float().cpu().numpy()


def make_pipe(inp, flat_key='flat', kw_key='pipe_kw', vq_key='vq'):
    cfg = tpl.PipelineConfig(vqc=tvm.VQModelConfig.from_dict(inp[vq_key]),
                             **inp[kw_key])
    pipe = tpl.Pipeline(cfg, stage1_pretrained=False, text_encoder=None,
                        device='cpu', seed=inp.get('seed', 0))
    if flat_key is not None:
        load_jax_params(pipe, inp[flat_key])
    return pipe


def rows(x, mesh):
    return pmesh.shard_batch(_t(x), mesh)


# ---------------------------------------------------------------------------
# tensor parallelism, sequence parallelism, int8 under TP, clipping
# ---------------------------------------------------------------------------

def job_tp(inp, mesh):
    from paintmind_tpu_torch.models import vqmodel as vm
    from paintmind_tpu_torch.ops.flash_attention import flash_attention
    from paintmind_tpu_torch.parallel.data_parallel import clip_by_global_norm
    out = {}
    x, ctx, img = rows(inp['x'], mesh), rows(inp['ctx'], mesh), \
        rows(inp['img'], mesh)
    pipe = make_pipe(inp).shard(mesh)
    with torch.no_grad():
        out['logits'] = _np(pipe.transformer(x, ctx))
        rec, loss = vm.forward(pipe.vqgan, img)
        out['rec'], out['vq_loss'] = _np(rec), float(loss)

        # K1's plain path on this rank's heads
        tp, r = mesh.size('model'), mesh.rank('model')
        q, k, v = (rows(inp[n], mesh) for n in ('q', 'k', 'v'))
        h = q.shape[2] // tp
        heads = slice(r * h, (r + 1) * h)
        out['attn'] = _np(flash_attention(q[:, :, heads], k[:, :, heads],
                                          v[:, :, heads], 0.25))

        # int8 w8a8 under TP: quantize whole, then carve
        qpipe = make_pipe(inp)
        qpipe.quantize('w8a8', min_dim=16)
        ref_q = _np(qpipe.transformer(x, ctx))
        qpipe.shard(mesh)
        out['q_logits'] = _np(qpipe.transformer(x, ctx))
        out['q_logits_unsharded'] = ref_q

        # int8 after the carve: shard(mesh).quantize(mode) holds the global
        # tree of quantize(mode), carved as quantize(mode).shard(mesh) is
        for mode in ('w8a8', 'w8'):
            whole = make_pipe(inp).quantize(mode, min_dim=16)
            after = make_pipe(inp).shard(mesh).quantize(mode, min_dim=16)
            before = (qpipe if mode == 'w8a8' else
                      make_pipe(inp).quantize(mode, min_dim=16).shard(mesh))
            full, want = pmesh.full_state_dict(after), whole.state_dict()
            local, local_want = after.state_dict(), before.state_dict()
            out[f'sq_{mode}'] = {
                'full_equal': full.keys() == want.keys() and all(
                    torch.equal(full[k], want[k]) for k in want),
                'local_equal': local.keys() == local_want.keys() and all(
                    torch.equal(local[k], local_want[k]) for k in local),
                'logits': _np(after.transformer(x, ctx))}

        # sequence parallelism: logits and the sampler loop
        sp = make_pipe(inp).shard(mesh, sequence_parallel=True)
        out['sp_logits'] = _np(sp.transformer(x, ctx))
        ref = make_pipe(inp)
        init = torch.full((x.shape[0], sp.num_tokens), sp.mask_token_id,
                          dtype=torch.int32)
        ids = []
        for p in (sp, pipe, ref):
            g = torch.Generator().manual_seed(7)
            ids.append(tpl.generate_ids(p, init, ctx, cfg=p.config,
                                        timesteps=4, topk=3, generator=g)[1])
        out['ids_sp'], out['ids_tp'], out['ids_ref'] = (_np(i) for i in ids)

    # global-norm clipping under TP, where it engages
    ref = make_pipe(inp)
    for p in (pipe, ref):
        p.transformer.requires_grad_(True)
        p.transformer(x, ctx).square().mean().backward()
    params = list(pipe.transformer.parameters())
    norm = clip_by_global_norm(params, 1e-3, mesh)
    norm_ref = torch.nn.utils.clip_grad_norm_(
        list(ref.transformer.parameters()), 1e-3)
    out['norm'], out['norm_ref'] = float(norm), float(norm_ref)
    full = pmesh.full_state_dict(pipe.transformer)
    grads = {n: p.grad for n, p in pipe.transformer.named_parameters()}
    out['clip_err'] = max(
        float((pmesh.uncarve_like(pipe.transformer, n, g)
               - dict(ref.transformer.named_parameters())[n].grad).abs().max())
        for n, g in grads.items())
    out['full_equal'] = all(
        torch.equal(full[n], t.detach())
        for n, t in ref.transformer.state_dict().items())
    out['counts'] = C.snapshot()
    return out


# ---------------------------------------------------------------------------
# data parallelism, ZeRO-1, sync-BN, DP-MoE routing
# ---------------------------------------------------------------------------

def _trainable_state(pipe):
    return {n: _np(p) for n, p in pipe.named_parameters()
            if n == 'mask_token' or n.startswith('transformer.')}


def job_dp(inp, mesh):
    from paintmind_tpu_torch.parallel.data_parallel import GradSync
    from paintmind_tpu_torch.train import steps as tsteps
    out = {}
    img, ctx, noise = (rows(inp[n], mesh) for n in ('img', 'ctx', 'noise'))

    # one AdamW step (clipping at 1.0) on this rank's rows
    pipe = make_pipe(inp)
    opt = pt.optim.adamw(pipe.trainable_parameters(), 1e-3, (0.9, 0.96),
                         weight_decay=0.05, max_grad_norm=1.0)
    step = tsteps.make_pipeline_train_step(pipe, opt, mesh=mesh)
    m = step(img, ctx, 0.7, noise=noise)
    out['loss'] = float(m['loss'])
    out['adamw'] = _trainable_state(pipe)

    if mesh.size('data') == 2:
        # ZeRO-1 against the replicated data-parallel Lion step
        res = {}
        for zero in (True, False):
            p = make_pipe(inp)
            params = p.trainable_parameters()
            tsteps._fp32_trainable(params, 'Pipeline')
            sync = GradSync(params, mesh, zero=zero, min_size=256)
            opt = pt.optim.lion(sync.opt_params, 1e-3, (0.9, 0.99),
                                weight_decay=0.0, max_grad_norm=1.0)
            step = tsteps.make_pipeline_train_step(p, opt, mesh=mesh,
                                                   grad_sync=sync)
            for ratio in (0.7, 0.5):  # two updates: the gradients start anew
                mm = step(img, ctx, ratio, noise=noise)
            names = ['mask_token'] + ['transformer.' + n for n, _ in
                                      p.transformer.named_parameters()]
            state = sync.full_state(opt, p, names, names)
            res[zero] = (float(mm['loss']), _trainable_state(p),
                         {names[i]: _np(s['exp_avg'])
                          for i, s in state['state'].items()}, sync.sliced)
        out['zero'], out['replicated'] = res[True], res[False]

        # DP-MoE with capacity drops: route the global batch
        from paintmind_tpu_torch.nn import moe as tmoe
        layer = tmoe.MoESwiGLU(16, 32, 4, num_selected=2,
                               capacity_factor=inp['moe_cf'], device='cpu')
        load_jax_params(layer, inp['moe_flat'])
        xt = rows(inp['moe_x'], mesh)
        layer.route_group = mesh.group('data')
        with torch.no_grad():
            y, aux = layer(xt)
            *_, keep, cap = tmoe.route(layer, xt.reshape(-1, 16), 2,
                                       inp['moe_cf'], mesh.group('data'))
        out['moe_y'] = _np(y)
        out['moe_aux'] = {k: _np(v) for k, v in aux.items()}
        out['moe_keep'], out['moe_cap'] = _np(keep), cap

        # the sync-BN discriminator: one stage-1 step on this rank's rows
        out['vqgan'] = _vqgan_step(inp, mesh)
    out['counts'] = C.snapshot()
    return out


def job_zero1(inp, mesh):
    """One ZeRO-1 Lion update on this rank's rows."""
    from paintmind_tpu_torch.parallel.data_parallel import GradSync
    from paintmind_tpu_torch.train import steps as tsteps
    img, ctx, noise = (rows(inp[n], mesh) for n in ('img', 'ctx', 'noise'))
    p = make_pipe(inp)
    params = p.trainable_parameters()
    tsteps._fp32_trainable(params, 'Pipeline')
    sync = GradSync(params, mesh, zero=True, min_size=256)
    opt = pt.optim.lion(sync.opt_params, 1e-3, (0.9, 0.99), weight_decay=0.0,
                        max_grad_norm=1.0)
    step = tsteps.make_pipeline_train_step(p, opt, mesh=mesh, grad_sync=sync)
    m = step(img, ctx, 0.7, noise=noise)
    return {'loss': float(m['loss']), 'weights': _trainable_state(p),
            'sliced': sync.sliced}


def _vqgan_step(inp, mesh):
    from paintmind_tpu_torch.convert.from_jax import load_discriminator_params
    from paintmind_tpu_torch.models import discriminator as tdisc
    from paintmind_tpu_torch.train import steps as tsteps
    vq = tvm.VQModel(tvm.VQModelConfig.from_dict(inp['vq']), device='cpu')
    load_jax_params(vq, inp['vq_flat'])
    dcfg = tdisc.DiscriminatorConfig(input_nc=3, ndf=8, n_layers=3)
    tx = lambda ps: pt.optim.adam(ps, 1e-3, (0.9, 0.99), 1.0)  # noqa: E731
    step = tsteps.make_vqgan_train_step(vq, tx, tx, dcfg=dcfg, mesh=mesh)
    load_discriminator_params(step.state['d'], inp['d_params'],
                              inp['d_stats'])
    m = step(rows(inp['vq_img'], mesh), eta=_t(inp['eta']))
    d = step.state['d']
    return {'metrics': {k: float(v) for k, v in m.items()},
            'g': {n: _np(p) for n, p in vq.named_parameters()},
            'd': {n: _np(t) for n, t in d.state_dict().items()}}


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def job_ep(inp, mesh):
    from paintmind_tpu_torch.models import moe_transformer as tmt
    cfg = tmt.MoECondTransformerConfig(**inp['cfg'])
    tr = tmt.MoECondTransformer(cfg, device='cpu')
    load_jax_params(tr, inp['flat'])
    pmesh.shard_params(tr, mesh, pmesh.moe_cond_transformer_param_spec(tr))
    with torch.no_grad():
        logits, aux = tr(rows(inp['x'], mesh), rows(inp['ctx'], mesh))
    return {'logits': _np(logits), 'aux': {k: _np(v) for k, v in aux.items()},
            'dispatch': [m.dispatch for m in tr.modules()
                         if hasattr(m, 'route_group')],
            'local_experts': tr.layers[0].ffnet.experts.w12.weight.shape[0],
            'counts': C.snapshot()}


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

def _holder(layers):
    m = torch.nn.Module()
    m.layers = layers
    return m


def make_stack(flat, depth, cross=True, experts=0, cf=2.0):
    from paintmind_tpu_torch.nn import moe as tmoe
    from paintmind_tpu_torch.nn import transformer as tnt
    kw = dict(dim_head=16, mlp_dim=64, num_head=2, context_dim=32)
    if experts:
        layers = tmoe.make_moe_stack(depth, 32, num_experts=experts,
                                     capacity_factor=cf, device='cpu', **kw)
    else:
        layers = tnt.make_stack(depth, 32, cross=cross, device='cpu',
                                **(kw if cross else {**kw,
                                                     'context_dim': None}))
    return load_jax_params(_holder(layers), flat).layers


def _stage_grads(layers, stage, stages):
    """{'<global layer>.<param>': grad} of this stage's layers."""
    per = len(layers) // stages
    out = {}
    for i in range(stage * per, (stage + 1) * per):
        for n, p in layers[i].named_parameters():
            if p.grad is not None:
                out[f'{i}.{n}'] = _np(p.grad)
    return out


def job_pp(inp, mesh):
    from paintmind_tpu_torch.models import moe_transformer as tmt
    from paintmind_tpu_torch.models import transformer as tst
    from paintmind_tpu_torch.nn.moe import moe_stack_apply
    from paintmind_tpu_torch.parallel import pipeline_parallel as pp
    out = {}
    stages, stage = mesh.size('model'), mesh.rank('model')
    with torch.no_grad():
        layers = make_stack(inp['stack8'], 8)
        x, ctx = _t(inp['x8']), _t(inp['ctx8'])
        for m in (2, 4):
            out[f'stack_m{m}'] = _np(pp.pp_stack_apply(
                layers, x, ctx, mesh=mesh, microbatches=m))
        plain = make_stack(inp['stack4_self'], 4, cross=False)
        out['no_ctx'] = _np(pp.pp_stack_apply(plain, x, mesh=mesh,
                                              microbatches=2))
        try:
            pp.pp_stack_apply(make_stack(inp['stack6_self'], 6, cross=False),
                              x, mesh=mesh, microbatches=2)
        except ValueError as e:
            out['depth_error'] = str(e)
        try:
            pp.pp_stack_apply(plain, x[:3], mesh=mesh, microbatches=2)
        except ValueError as e:
            out['batch_error'] = str(e)

    # the backward: each stage's layers' gradients
    layers = make_stack(inp['stack4'], 4)
    layers.requires_grad_(True)
    xb, cb, tgt = _t(inp['xb']), _t(inp['cb']), _t(inp['tgt'])
    y = pp.pp_stack_apply(layers, xb, cb, mesh=mesh, microbatches=2)
    ((y - tgt) ** 2).mean().backward()
    out['grads'] = _stage_grads(layers, stage, stages)

    # MoE stacks: forward with aux, and the backward
    moe = make_stack(inp['moe8'], 8, experts=4, cf=2.0)
    xm, cm = _t(inp['xm']), _t(inp['cm'])
    with torch.no_grad():
        ym, aux = pp.pp_moe_stack_apply(moe, xm, cm, mesh=mesh,
                                        microbatches=2)
    out['moe'], out['moe_aux'] = _np(ym), {k: _np(v) for k, v in aux.items()}
    moe4 = make_stack(inp['moe4'], 4, experts=4, cf=2.0)
    moe4.requires_grad_(True)
    ym, aux = pp.pp_moe_stack_apply(moe4, xb, cb, mesh=mesh, microbatches=2)
    (((ym - tgt) ** 2).mean() + 1e-3 * aux['router_z']).backward()
    out['moe_grads'] = _stage_grads(moe4, stage, stages)
    # the port's own unpipelined MoE stack, for the same gradients
    ref = make_stack(inp['moe4'], 4, experts=4, cf=2.0)
    ref.requires_grad_(True)
    yr, auxr = moe_stack_apply(ref, xb, cb)
    (((yr - tgt) ** 2).mean() + 1e-3 * auxr['router_z']).backward()
    out['moe_grads_ref'] = _stage_grads(ref, 0, 1)

    # the stage-2 transformer through shard_for_pp
    cfg = tst.CondTransformerConfig(**inp['tcfg'])
    tr = load_jax_params(tst.CondTransformer(cfg, device='cpu'), inp['tflat'])
    spec = pp.pp_cond_transformer_param_spec(tr, stages)
    pp.shard_for_pp(tr, mesh, 2)
    out['spec_held'] = sorted(n for n, s in spec.items() if s == stage) == \
        sorted(n for n, _ in tr.named_parameters() if n.startswith('layers.'))
    out['spec_replicated'] = sorted(n for n, s in spec.items() if s is None)
    with torch.no_grad():
        out['transformer'] = _np(pp.pp_cond_transformer_apply(
            tr, _t(inp['tx']), _t(inp['tctx']), mesh=mesh, microbatches=2))
    out['held'] = sorted(int(k) for k in tr.layers.keys())

    # the guards
    mcfg = tmt.MoECondTransformerConfig(**{**inp['tcfg'], 'num_experts': 2})
    try:
        pp.pp_cond_transformer_apply(tmt.MoECondTransformer(mcfg, device='cpu'),
                                     _t(inp['tx']), mesh=mesh, microbatches=2)
    except TypeError as e:
        out['moe_type_error'] = str(e)
    pipe3 = make_pipe({**inp, 'pipe_kw': {**inp['pipe_kw'], 'depth': 3}},
                      flat_key=None)
    try:
        pipe3.enable_pipeline_parallel(mesh, 2)
    except ValueError as e:
        out['pipe_depth_error'] = str(e)
    flat_mesh = pmesh.make_mesh(1)
    try:
        make_pipe(inp, flat_key=None).enable_pipeline_parallel(flat_mesh, 2)
    except ValueError as e:
        out['stages_error'] = str(e)
    out['counts'] = C.snapshot()
    return out


class SynthDataset:
    """Seeded random images in [-1, 1] (and captions when asked)."""

    def __init__(self, n, size=32, with_caption=False):
        self.n, self.size, self.with_caption = n, size, with_caption

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.random.default_rng(i).uniform(
            -1, 1, (self.size, self.size, 3)).astype(np.float32)
        return (img, f'caption {i}') if self.with_caption else img


def trainer(pipe, folder, mesh=None, **kw):
    from paintmind_tpu_torch.utils.trainer import PaintMindTrainer
    args = dict(num_epoch=1, valid_size=4, optim_name='adamw', lr=1e-3,
                warmup_steps=1, decay_steps=10, batch_size=8, num_workers=1,
                grad_accum_steps=1, mixed_precision='no', save_every=1000,
                sample_every=1000, result_folder=folder,
                log_dir=os.path.join(folder, 'log'), seed=5, cfg_p=0.0,
                mesh=mesh)
    args.update(kw)
    return PaintMindTrainer(pipe, SynthDataset(40), **args)


def _full_trainable(pipe):
    full = pmesh.full_state_dict(pipe)
    return {k: _np(v) for k, v in full.items()
            if k == 'mask_token' or k.startswith('transformer.')}


def job_pp2(inp, mesh):
    from paintmind_tpu_torch.parallel import pipeline_parallel as pp
    out = {}
    with torch.no_grad():
        layers = make_stack(inp['stack4'], 4)
        out['stack_m4'] = _np(pp.pp_stack_apply(
            layers, rows(inp['x16'], mesh), rows(inp['ctx16'], mesh),
            mesh=mesh, microbatches=4))

    # the PP trainer (dense, then MoE) against the plain trainer
    d = inp['dir']
    for name, kw in (('dense', 'pipe_kw'), ('moe', 'moe_kw')):
        runs = {}
        for staged in (True, False):
            p = make_pipe(inp, flat_key=None, kw_key=kw)
            t = trainer(p, os.path.join(d, f'{name}_{staged}_{mesh.rank("data")}'
                                        f'_{mesh.rank("model")}'),
                        mesh=mesh if staged else None,
                        pp_microbatches=2 if staged else None)
            t.train()
            runs[staged] = (t.steps, float(t.log['loss']), _full_trainable(p))
        out[f'trainer_{name}'] = runs

    # PP decode against the dense decode, unguided and guided; then
    # disabled (the unstaged decode again) and enabled once more
    ctx = _t(inp['gctx'])

    def decode(p):
        res = []
        for guidance in (None, 2.0):
            imgs = p.generate(text=ctx, timesteps=2, temperature=0.0,
                              topk=1, guidance_scale=guidance,
                              decode_steps='final',
                              generator=torch.Generator().manual_seed(42))
            init = torch.full((4, p.num_tokens), p.mask_token_id,
                              dtype=torch.int32)
            ids = tpl.generate_ids(
                p, init, ctx, cfg=p.config, timesteps=2, temperature=0.0,
                topk=1, guidance_scale=guidance,
                generator=torch.Generator().manual_seed(42))[0]
            res.append((_np(imgs[-1]), _np(ids)))
        return res

    for name, kw in (('dense', 'pipe_kw'), ('moe', 'moe_kw')):
        res = {False: decode(make_pipe(inp, flat_key=None, kw_key=kw))}
        p = make_pipe(inp, flat_key=None, kw_key=kw)
        res[True] = decode(p.enable_pipeline_parallel(mesh, 2))
        res['disabled'] = decode(p.disable_pipeline_parallel())
        res['unstaged'] = (p.mesh is None and p.transformer._pp is None
                           and type(p.transformer.layers) is torch.nn.ModuleList
                           and len(p.transformer.layers) == p.config.depth)
        res['again'] = decode(p.enable_pipeline_parallel(mesh, 2))
        out[f'generate_{name}'] = res

    # int8 on a staged pipeline: each stage quantizes the whole layers it
    # holds (the JAX package's stage-placed tree), and unstaging it gives
    # quantize(mode)'s pipeline
    whole = make_pipe(inp, flat_key=None).quantize('w8', min_dim=16)
    p = make_pipe(inp, flat_key=None).enable_pipeline_parallel(mesh, 2)
    p.quantize('w8', min_dim=16)
    full, want = pmesh.full_state_dict(p), whole.state_dict()
    out['pp_quant_full_equal'] = full.keys() == want.keys() and all(
        torch.equal(full[k], want[k]) for k in want)
    res = {'staged': decode(p)}
    got = p.disable_pipeline_parallel().state_dict()
    out['pp_quant_unstaged_equal'] = list(got) == list(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    res['unstaged'], res['whole'] = decode(p), decode(whole)
    out['pp_quant_decode'] = res
    try:
        make_pipe(inp, flat_key=None).shard(mesh).enable_pipeline_parallel(
            mesh, 2)
    except RuntimeError as e:
        out['sharded_stage_error'] = str(e)
    out['counts'] = C.snapshot()
    return out


# ---------------------------------------------------------------------------
# resume across meshes, the engine
# ---------------------------------------------------------------------------

def first_batches(t, n):
    out = []
    for b in t.train_dl:
        out.append(b)
        if len(out) == n:
            return out
    raise AssertionError('the loader ran out')


def job_resume(inp, mesh):
    pipe = make_pipe(inp, flat_key=None)
    pp = inp['phase'] == 'resume_pp'
    t = trainer(pipe, inp['dir'], mesh=mesh, ema_decay=0.9,
                pp_microbatches=2 if pp else None)
    batches = first_batches(t, 4)
    out = {}
    if pp:
        t.resume(inp['path'])
        out['steps'] = t.steps
        losses = [float(t.train_step(b)['loss']) for b in batches[2:]]
    else:
        losses = [float(t.train_step(b)['loss']) for b in batches[:2]]
        out['path'] = t.save()
        losses += [float(t.train_step(b)['loss']) for b in batches[2:]]
    out['losses'] = losses
    out['weights'] = _full_trainable(pipe)
    out['ema'] = [_np(e) for e in t._gather_list(pipe, t.state['ema'],
                                                 t._local_names())]
    out['counts'] = C.snapshot()
    return out


def job_engine(inp, mesh):
    from paintmind_tpu_torch.serving.engine import (GenerateRequest,
                                                    GenerationEngine)
    pipe = make_pipe(inp, flat_key=None)
    eng = GenerationEngine(pipe, mesh=mesh, max_batch=4, max_wait_ms=500)
    if not eng.leader:
        return {'followed': eng.follow()}
    futs = [eng.submit(GenerateRequest(context=inp['ctx'][i], seed=i,
                                       guidance_scale=2.0, timesteps=3,
                                       topk=3))
            for i in range(3)]
    imgs = [f.result(timeout=200) for f in futs]
    stats = eng.stats()
    eng.close()
    return {'imgs': imgs, 'batches': stats['batches'],
            'thread_alive': eng._thread.is_alive(), 'counts': C.snapshot()}


JOBS = {'tp': job_tp, 'dp': job_dp, 'zero1': job_zero1, 'ep': job_ep,
        'pp': job_pp,
        'pp2': job_pp2, 'resume': job_resume, 'engine': job_engine}


def torchrun_train(argv):
    """Under torchrun: register the tiny versions and run train_paintmind
    from the directory ``rank<RANK>`` (so that a file a rank writes shows
    whose it is)."""
    import json
    for name, cfg in json.loads(os.environ['PM_TEST_VERSIONS']).items():
        pt.register_version(name, cfg)
    torch.set_num_threads(1)
    cwd = f'rank{os.environ["RANK"]}'
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    from paintmind_tpu_torch.scripts import train_paintmind
    train_paintmind.main(argv)


def main():
    if sys.argv[1] == 'torchrun-train':
        return torchrun_train(sys.argv[2:])
    job, rank, world, port, d, model = sys.argv[1:7]
    torch.set_num_threads(1)
    multihost.initialize(f'127.0.0.1:{port}', int(world), int(rank),
                         device='cpu')
    inp = torch.load(os.path.join(d, 'in.pt'), weights_only=False)
    for name, cfg in inp.get('register', {}).items():
        pt.register_version(name, cfg)
    mesh = pmesh.make_mesh(int(model))
    out = JOBS[job](inp, mesh)
    torch.save(out, os.path.join(d, f'out_{rank}.pt'))
    multihost.barrier()
    multihost.shutdown()


if __name__ == '__main__':
    main()
