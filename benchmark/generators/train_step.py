"""Stage-2 training: back-to-back ``PaintMindTrainer.train_step`` updates.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``grad_accum``,
``corpus`` (seeded 256-pixel images, cached on the card by the port's
``DeviceCacheLoader`` at its pre-crop size), ``context_len`` and
``context_scale`` (one seeded context per corpus image, so no tower runs),
``trainer`` (keyword arguments of ``PaintMindTrainer`` beyond its
defaults) and ``followed`` (the set-up's updates that the reference
follows, ``check.judge_train``).

Set-up builds the trainer once and drives it through ``followed`` updates
with the window's own call and feed, keeping (by hooks on the port's
modules) what each update saw: the images, the codes its VQGAN encode
chose, the masked tokens and contexts, the dropout keep-masks; after the
first update the optimizer's moments, after the last the parameters.  The
same trainer then runs the window, one update after another, each ended
by reading its loss (as the trainer's own loop logs every update).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import check as judge  # noqa: E402
import program  # noqa: E402
import weights as seeded  # noqa: E402


class State:
    pass


def _images(n, size, seed, device):
    """Smooth seeded uint8 images (bicubic-upsampled noise), (n, size,
    size, 3)."""
    g = torch.Generator(device=device).manual_seed(seed)
    low = torch.rand(n, 3, 16, 16, device=device, generator=g) * 2 - 1
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode='bicubic', align_corners=False)
    img = ((img.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()


def setup(run):
    import paintmind_tpu_torch as pt
    from paintmind_tpu_torch.utils.device_cache import DeviceCacheLoader
    cfg, tr = run.cell.config, run.cell.traffic
    s = State()
    s.run, s.cfg, s.tr = run, cfg, tr
    w = seeded.make(cfg, run.rng_seed('weights'), run.device, torch.float32)
    s.pipe = program.build_pipeline(cfg, w.tensors(), run.device, train=True)
    s.weights = w.to('cpu')
    del w
    size = cfg['stage1']['enc']['image_size']
    pre = int(size / 0.8)
    s.corpus = _images(tr['corpus'], pre, run.rng_seed('images'), run.device)
    g = torch.Generator(device=run.device).manual_seed(run.rng_seed('contexts'))
    s.contexts = torch.randn(tr['corpus'], tr['context_len'], cfg['t5_dim'],
                             generator=g, device=run.device) * tr['context_scale']
    s.loader = DeviceCacheLoader(s.corpus.cpu().numpy(), tr['batch'] * tr['grad_accum'],
                                 img_size=size, seed=run.rng_seed('loader') % 2 ** 31,
                                 device=run.device, return_indices=True)
    s.tmp = tempfile.mkdtemp()
    s.trainer = pt.PaintMindTrainer(
        s.pipe, None, num_epoch=1, batch_size=tr['batch'],
        grad_accum_steps=tr['grad_accum'], train_loader=s.loader,
        valid_loader=s.loader, result_folder=s.tmp, log_dir=s.tmp,
        seed=run.rng_seed('trainer') % 2 ** 31, **tr['trainer'])
    s.batches = _batches(s)
    s.followed = _follow(s, int(tr['followed']))
    if run.device != 'cpu':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return s


def _batches(s):
    while True:
        yield from s.loader


def _update(s):
    imgs, idx = next(s.batches)
    s.last_feed = imgs, idx
    return s.trainer.train_step((imgs, s.contexts[idx]))


def _follow(s, n):
    """``n`` updates with hooks that keep what each saw."""
    pipe = s.pipe
    seen = []
    cur = {}

    def attn_hook(m, a, out):
        cur['keeps'].append((out != 0).to('cpu', copy=True))

    hooks = [
        pipe.vqgan.encoder.register_forward_pre_hook(
            lambda m, a: cur.__setitem__('images', a[0].detach().to('cpu', copy=True))),
        pipe.vqgan.quantize.register_forward_hook(
            lambda m, a, out: cur.__setitem__('ids', out[2].detach().to('cpu', copy=True))),
        pipe.transformer.register_forward_pre_hook(
            lambda m, a: cur.update(tokens=a[0].detach().to('cpu', copy=True),
                                    context=None if a[1] is None
                                    else a[1].detach().to('cpu', copy=True)))]
    for blk in pipe.transformer.layers:
        hooks += [blk.attn1.register_forward_hook(attn_hook),
                  blk.attn2.register_forward_hook(attn_hook)]
    names = ['mask_token'] + ['transformer.' + n for n, _ in
                              pipe.transformer.named_parameters()]
    params = pipe.trainable_parameters()
    opt = s.trainer.state['opt']
    try:
        for i in range(n):
            cur.clear()
            cur['keeps'] = []
            metrics = _update(s)
            cur['loss'] = float(metrics['loss'])
            cur['fed'] = s.last_feed[0].to('cpu', copy=True)
            cur['idx'] = s.last_feed[1].to('cpu', copy=True)
            if i == 0:
                cur['moments'] = {nm: opt.state[p]['exp_avg'].detach().to('cpu', copy=True)
                                  for nm, p in zip(names, params)
                                  if 'exp_avg' in opt.state[p]}
            seen.append(dict(cur))
    finally:
        for h in hooks:
            h.remove()
    seen[-1]['params'] = {nm: p.detach().to('cpu', copy=True) for nm, p in zip(names, params)}
    return seen


def window(s, seconds):
    before = program.kernel_counters()
    t0 = time.perf_counter()
    steps = 0
    while True:
        float(_update(s)['loss'])
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    after = program.kernel_counters()
    images = steps * s.tr['batch'] * s.tr['grad_accum']
    return {'seconds': elapsed, 'steps': steps, 'images': images,
            'attempted': steps, 'failed': 0,
            'launches': {k: after[k] - before[k] for k in after}}


def end_to_end(s, stats):
    return {'train_images_per_s': stats['images'] / stats['seconds']}


def trace_hooks(s):
    """Counts the updates whose text was dropped (the transformer then
    gets no context)."""
    s.dropped = 0

    def pre(m, a):
        if a[1] is None:
            s.dropped += 1

    return [s.pipe.transformer.register_forward_pre_hook(pre)]


def counters(s, stats):
    return {'steps': stats['steps'], 'launches': stats['launches'],
            'dropped': s.dropped // s.tr['grad_accum']}


def release(s):
    del s.trainer, s.pipe, s.loader, s.batches
    shutil.rmtree(s.tmp, ignore_errors=True)
    gc.collect()
    if s.run.device != 'cpu':
        torch.cuda.empty_cache()


def check(s, stats):
    return judge.judge_train(s, s.run.cell.check)
