"""Train steps (``paintmind_tpu/train/steps.py``): stage-1 adversarial
VQGAN and stage-2 MaskGIT.

Stage 1 (reference trainer.py:171-259), per optimizer update:
  D phase: rec = vqgan(img), hinge-D loss on D(rec) / D(img) plus the WGAN
  gradient penalty on interpolates (a double backward through D,
  trainer.py:153-169, 193-194) -> Adam update of D.
  G phase, against the *updated* D (the reference's order): codebook loss +
  L1 + MSE reconstruction + LPIPS + 0.1 * non-saturating G loss
  (trainer.py:210-218) -> Adam update of the VQGAN.
With ``share_forward`` one VQGAN forward per microbatch serves both phases:
the D phase sees the detached reconstruction, and the G loss later
back-propagates through the graph that forward kept.  D's BatchNorm
statistics move in the JAX package's order: per microbatch D on the fakes,
the reals and the interpolates, then per microbatch D on the fakes of the G
phase, once each.

Stage 2 (reference trainer.py:377-398): the masked-CE pipeline loss, with
the arccos mask ratio and the batch-level CFG text dropout drawn by the
trainer, then a Lion / AdamW update of ``transformer`` and ``mask_token``
only (the VQGAN is frozen).

Mechanics: gradient accumulation is a Python loop over microbatches whose
``backward()`` calls sum into ``.grad``; the sum is scaled by
``1 / grad_accum`` before the one update.  bf16 compute over fp32 master
parameters: the images and the context are cast, the layers cast their own
parameters to the activations' type per call, and LayerNorm statistics,
softmax and the loss stay in fp32.  On a CUDA device every attention's
forward and backward is a hand-written kernel (``ops/flash_attention``).

On a CUDA device every attention's forward and backward is a hand-written
kernel (``ops/flash_attention``), and every encode's code lookup is K2.

Under a mesh (``mesh=``, ``parallel.mesh.make_mesh``) a step takes this
data rank's rows of the global batch (``parallel.mesh.shard_batch``: of
every microbatch, the rank's slice), and the per-row random draws (masking
noise, dropout masks, the gradient penalty's mix) are the rank's rows of the
global batch's draws from the generator every rank holds, so a data-parallel
update equals the one-device update of the global batch.  After the
microbatches the gradients are averaged over 'data' (``grad_sync``:
``parallel.data_parallel.GradSync``, ZeRO-1 when it slices), the clipping
norm is taken over the mesh, and the MoE routing and the discriminator's
BatchNorm statistics are those of the global batch.  The metrics are the
means over the global batch.
"""

from __future__ import annotations

import contextlib

import torch

from ..models import discriminator as disc_mod
from ..models import pipeline as pl
from ..models import vqmodel as vm
from ..models.quantize import l2norm
from ..nn.core import global_rows
from ..parallel import collectives as C
from ..utils.profiling import annotate


def _cast(x, dtype):
    return x if dtype is None or x is None else x.to(dtype)


@torch.no_grad()
def _ema_update(ema, new, decay):
    """``decay·ema + (1 − decay)·new``, in place on the ``ema`` tensors."""
    for e, p in zip(ema, new):
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


class _DataRanks:
    """What a step needs of the mesh's 'data' axis (None: one device)."""

    def __init__(self, mesh):
        self.dp = 1 if mesh is None else mesh.size('data')
        self.rank = 0 if mesh is None else mesh.rank('data')
        self.group = None if mesh is None else mesh.group('data')
        self.on = mesh is not None

    def rows(self, micro):
        """The global-batch draws of one microbatch of ``micro`` local rows."""
        if not self.on:
            return contextlib.nullcontext()
        return global_rows(self.rank * micro, micro * self.dp)

    def mean(self, metrics):
        """Metrics (0-d or (E,) tensors) averaged over the data ranks."""
        if self.dp == 1:
            return metrics
        keys = list(metrics)
        flat = torch.cat([metrics[k].detach().float().reshape(-1)
                          for k in keys])
        C.all_reduce(flat, self.group).div_(self.dp)
        out, at = {}, 0
        for k in keys:
            n = metrics[k].numel()
            out[k] = flat[at:at + n].reshape(metrics[k].shape)
            at += n
        return out

    @contextlib.contextmanager
    def routing(self, module):
        """Route the MoE layers of ``module`` on the global batch while the
        step runs (the data group set on each ``MoESwiGLU``)."""
        from ..nn.moe import MoESwiGLU
        mods = ([m for m in module.modules() if isinstance(m, MoESwiGLU)]
                if self.dp > 1 else [])
        for m in mods:
            m.route_group = self.group
        try:
            yield
        finally:
            for m in mods:
                m.route_group = None


def _zero_grads(optimizer, params, grad_sync):
    """Clear the optimizer's gradients, and the parameters' where the
    optimizer holds ZeRO slices of them instead."""
    optimizer.zero_grad(set_to_none=True)
    if grad_sync is not None:
        for p in params:
            p.grad = None


def _update(optimizer, params, grad_accum, grad_sync):
    """Mean gradients -> (data-parallel reduce) -> the update -> (ZeRO
    gather)."""
    _average_grads(params, grad_accum)
    if grad_sync is not None:
        grad_sync.reduce()
    optimizer.step()
    if grad_sync is not None:
        grad_sync.gather()


def _grad_sync(params, optimizer, mesh, grad_sync, pipe_sum=()):
    """The step's ``GradSync``: the given one, or plain data parallelism
    over ``params`` (the optimizer built over them) on ``mesh``."""
    if mesh is None:
        if grad_sync is not None:
            raise ValueError('grad_sync needs mesh=')
        return None
    if grad_sync is None:
        from ..parallel.data_parallel import GradSync
        grad_sync = GradSync(params, mesh, pipe_sum=pipe_sum)
    grad_sync.install(optimizer)
    return grad_sync


# ---------------------------------------------------------------------------
# Stage 1: VQGAN adversarial step
# ---------------------------------------------------------------------------

def _fp32_trainable(params, what):
    """Mark ``params`` trainable; they are the master weights, so they must
    be fp32 (a model built with a ``compute_dtype`` holds its weights in that
    type and is for inference)."""
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError(f'training updates fp32 master weights: build the '
                         f'{what} with compute_dtype=None (the step casts '
                         'the activations, not the weights)')
    for p in params:
        p.requires_grad_(True)


def init_vqgan_train_state(vqgan, g_tx, d_tx,
                           dcfg=disc_mod.DiscriminatorConfig(), ema_decay=None,
                           codebook_restart_every=None, seed=0):
    """The mutable state of stage-1 training around ``vqgan`` (trained in
    place): the update count, the generator optimizer ``g_tx(params)``, a
    seeded ``Discriminator`` and its optimizer ``d_tx(params)`` (``g_tx`` and
    ``d_tx`` build an optimizer over a parameter list, e.g. ``lambda ps:
    optim.adam(ps, lr, (0.9, 0.99), 1.0)``), the generator that draws the
    gradient penalty's mix and the codebook restart's picks, and, as asked,
    an EMA copy of the VQGAN's parameters (in ``vqgan.parameters()`` order)
    and the code-usage counts of the restart window."""
    params = list(vqgan.parameters())
    _fp32_trainable(params, 'VQModel')
    d = disc_mod.Discriminator(dcfg, seed=seed, device=vqgan.device)
    state = {
        'step': 0,
        'g_opt': g_tx(params),
        'd': d,
        'd_opt': d_tx(list(d.parameters())),
        'generator': torch.Generator(device=vqgan.device).manual_seed(seed),
    }
    if ema_decay is not None:
        state['g_ema'] = [p.detach().clone() for p in params]
    if codebook_restart_every is not None:
        state['code_usage'] = torch.zeros(vqgan.config.n_embed, dtype=torch.int64,
                                          device=vqgan.device)
    return state


def vqgan_d_loss(d, img, rec, eta):
    """The D phase's loss on one microbatch: D on the (detached) fakes, on
    the reals, the gradient penalty on their ``eta`` mix (BatchNorm
    statistics move in that order), hinge loss plus penalty."""
    fake = d(rec, train=True)
    real = d(img, train=True)
    gp = disc_mod.gradient_penalty(d, img, rec, eta)
    return disc_mod.hinge_d_loss(fake, real) + gp


def vqgan_g_loss(rec, cb_loss, d, img, lpips=None, d_weight=0.1):
    """The G phase's loss terms as a function of (rec, codebook loss) ->
    (total, metrics): L1 + MSE reconstruction, LPIPS (0 without a model),
    the non-saturating G loss of D (training mode: its statistics move)."""
    rec_loss = torch.mean(torch.abs(rec - img)) + torch.mean(torch.square(rec - img))
    per_loss = (torch.mean(lpips(rec, img)) if lpips is not None
                else rec.new_zeros(()))
    g_loss = disc_mod.g_nonsaturating_loss(d(rec, train=True))
    total = cb_loss + rec_loss + per_loss + d_weight * g_loss
    return total, {'rec loss': rec_loss, 'per loss': per_loss,
                   'g loss': g_loss, 'codebook loss': cb_loss}


def make_vqgan_train_step(vqgan, g_tx, d_tx, *,
                          dcfg=disc_mod.DiscriminatorConfig(), lpips=None,
                          d_weight=0.1, grad_accum=1, compute_dtype=None,
                          backend=None, vq_backend='auto', remat=False,
                          ema_decay=None, codebook_restart_every=None,
                          share_forward=True, state=None, seed=0, mesh=None,
                          g_sync=None, d_sync=None):
    """Returns ``step(imgs, eta=None, picks=None) -> metrics``, which
    updates ``vqgan``, the discriminator and the train state in place; the
    state (``init_vqgan_train_state``, built here unless given) is readable
    as ``step.state``.  ``imgs``: (grad_accum · micro, H, W, C) fp32 in
    [-1, 1]; ``lpips``: an ``models.lpips.LPIPS`` or None (no perceptual
    term).  ``eta``: (B, 1, 1, 1) gradient-penalty mixes, and ``picks``:
    (n_embed,) latent rows for a codebook restart, in place of the state's
    generator's draws (the tests pass the JAX step's).  ``remat``
    recomputes the VQGAN's blocks in the backward pass.

    ``share_forward`` (default): one VQGAN forward per microbatch; its
    graph is kept through the D update (all ``grad_accum`` of them: use
    ``remat`` at large accumulation) and the G loss, computed against the
    updated D, back-propagates through it.  D's parameters are switched out
    of autograd for the G phase, so the G backward leaves no gradient in
    them.  ``share_forward=False`` is the reference's two-forward form: the
    D phase runs the forward again under ``no_grad``.

    ``codebook_restart_every`` (an extension of the JAX package): every N
    updates, codebook rows no microbatch used in the window are replaced by
    l2-normalised encoder latents of the last microbatch, at the picked
    rows.  The metrics are 0-d tensors on the device: the means over the
    microbatches of 'rec loss', 'per loss', 'g loss', 'codebook loss',
    'loss', 'd loss', and 'restarted codes' with a restart window.

    ``mesh``: data parallelism over its 'data' axis (``imgs`` this rank's
    rows, ``parallel.mesh.shard_batch``; ``eta`` and ``picks`` global);
    ``g_sync`` / ``d_sync``: the ``GradSync`` of each optimizer (ZeRO-1),
    else plain data parallelism."""
    if state is None:
        state = init_vqgan_train_state(vqgan, g_tx, d_tx, dcfg, ema_decay,
                                       codebook_restart_every, seed)
    if (ema_decay is None) != ('g_ema' not in state):
        raise ValueError('ema_decay must be given to both '
                         'init_vqgan_train_state and the step')
    if (codebook_restart_every is None) != ('code_usage' not in state):
        raise ValueError('codebook_restart_every must be given to both '
                         'init_vqgan_train_state and the step')
    cfg = vqgan.config
    g_params = list(vqgan.parameters())
    d = state['d']
    d_params = list(d.parameters())
    kw = dict(backend=backend, remat=remat)
    ranks = _DataRanks(mesh)
    g_sync = _grad_sync(g_params, state['g_opt'], mesh, g_sync)
    d_sync = _grad_sync(d_params, state['d_opt'], mesh, d_sync)
    if ranks.dp > 1:
        d.sync_group = ranks.group

    def forward_full(img):
        z, cb_loss, ids = vm.encode(vqgan, _cast(img, compute_dtype),
                                    vq_backend=vq_backend, **kw)
        return vm.decode(vqgan, z, **kw).float(), cb_loss, ids

    def d_phase(imgs, eta, recs):
        """One D update; ``recs[i]`` is microbatch i's reconstruction, or
        None to compute it here without a graph (two-pass form)."""
        _zero_grads(state['d_opt'], d_params, d_sync)
        loss_sum = 0.0
        for i in range(grad_accum):
            rec = recs[i]
            if rec is None:
                with torch.no_grad():
                    rec = forward_full(imgs[i])[0]
            loss = vqgan_d_loss(d, imgs[i], rec.detach(), eta[i])
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        _update(state['d_opt'], d_params, grad_accum, d_sync)
        return loss_sum

    def step(imgs, eta=None, picks=None):
        b = imgs.shape[0]
        if b % grad_accum:
            raise ValueError(f'batch size {b} not divisible by '
                             f'grad_accum_steps={grad_accum}')
        micro = b // grad_accum
        imgs = imgs.float().reshape(grad_accum, micro, *imgs.shape[1:])
        if eta is None:
            eta = torch.rand(b * ranks.dp, 1, 1, 1, device=imgs.device,
                             generator=state['generator'])
        eta = eta.to(imgs.device, torch.float32).reshape(
            grad_accum, ranks.dp, micro, 1, 1, 1)[:, ranks.rank]
        _zero_grads(state['g_opt'], g_params, g_sync)

        if share_forward:
            fwd = [forward_full(img) for img in imgs]
            d_loss_sum = d_phase(imgs, eta, [f[0] for f in fwd])
        else:
            fwd = [None] * grad_accum
            d_loss_sum = d_phase(imgs, eta, fwd)

        sums = dict.fromkeys(('rec loss', 'per loss', 'g loss',
                              'codebook loss', 'loss'), 0.0)
        all_ids = []
        d.requires_grad_(False)  # the G backward reaches the generator only
        try:
            for i in range(grad_accum):
                rec, cb_loss, ids = fwd[i] or forward_full(imgs[i])
                fwd[i] = None  # its graph goes with its backward
                total, metrics = vqgan_g_loss(rec, cb_loss, d, imgs[i], lpips,
                                              d_weight)
                total.backward()
                for k, v in {**metrics, 'loss': total}.items():
                    sums[k] = sums[k] + v.detach()
                all_ids.append(ids)
        finally:
            d.requires_grad_(True)
        _update(state['g_opt'], g_params, grad_accum, g_sync)
        state['step'] += 1

        out = {k: v / grad_accum for k, v in sums.items()}
        out['d loss'] = d_loss_sum / grad_accum
        out = ranks.mean(out)
        if codebook_restart_every is not None:
            out['restarted codes'] = _codebook_restart(
                imgs[-1], torch.cat([i.reshape(-1) for i in all_ids]), picks)
        if ema_decay is not None:
            _ema_update(state['g_ema'], g_params, ema_decay)
        return out

    @torch.no_grad()
    def _codebook_restart(img, ids, picks):
        usage = state['code_usage']
        used = torch.bincount(ids.long(), minlength=cfg.n_embed)
        usage += C.all_reduce(used, ranks.group) if ranks.dp > 1 else used
        if state['step'] % codebook_restart_every:
            return torch.zeros((), dtype=torch.int64, device=usage.device)
        # candidate rows: l2-normalised encoder latents of the last
        # microbatch, with the updated weights (codebook rows are
        # l2-normalised at every use, so this is scale-consistent)
        x = vqgan.encoder(_cast(img, compute_dtype), backend=backend)
        lat = l2norm(vqgan.prev_quant(x)).reshape(-1, cfg.embed_dim)
        if ranks.dp > 1:  # the global microbatch's latents, in rank order
            lat = C.all_gather(lat.contiguous(), ranks.group, 0)
        if picks is None:
            picks = torch.randint(0, lat.shape[0], (cfg.n_embed,),
                                  device=lat.device,
                                  generator=state['generator'])
        codebook = vqgan.quantize.codebook
        dead = usage == 0
        cand = lat[picks.to(lat.device).long()].to(codebook.dtype)
        codebook.copy_(torch.where(dead[:, None], cand, codebook))
        usage.zero_()
        return dead.sum()

    step.state = state
    step.grad_sync = g_sync, d_sync
    return step


def _average_grads(params, grad_accum):
    """Summed microbatch gradients -> their mean; a parameter no microbatch
    reached gets a zero gradient, as in optax (its moments still move)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif grad_accum > 1:
            p.grad.mul_(1.0 / grad_accum)


# ---------------------------------------------------------------------------
# Stage 2: MaskGIT pipeline step
# ---------------------------------------------------------------------------

def init_pipeline_train_state(pipe, optimizer, ema_decay=None, seed=0):
    """The mutable training state around ``pipe``: the update count, the
    optimizer, the generator that feeds masking noise and dropout, and (with
    ``ema_decay``) an EMA copy of the trainable tensors only, in the order
    of ``pipe.trainable_parameters()``.  Marks those parameters trainable
    (fp32 master weights: ``_fp32_trainable``)."""
    params = pipe.trainable_parameters()
    _fp32_trainable(params, 'Pipeline')
    state = {
        'step': 0,
        'opt': optimizer,
        'generator': torch.Generator(device=pipe.device).manual_seed(seed),
    }
    if ema_decay is not None:
        state['ema'] = [p.detach().clone() for p in params]
    return state


def make_pipeline_train_step(pipe, optimizer, *, grad_accum=1,
                             compute_dtype=None, backend=None,
                             vq_backend='auto', remat=False, ema_decay=None,
                             state=None, transformer_apply=None, mesh=None,
                             grad_sync=None):
    """Returns ``step(imgs, context, mask_ratio, noise=None) -> metrics``,
    which updates ``pipe`` and the train state in place.  The state is
    ``state`` (from ``init_pipeline_train_state``, e.g. to choose its seed)
    or a fresh one, and is readable as ``step.state``.  ``imgs``:
    (grad_accum · micro, H, W, C) in [-1, 1]; ``context``: (B, M, t5_dim) or
    None (the trainer drops the text of a whole batch with p = 0.1, reference
    trainer.py:387-388); ``mask_ratio``: the per-batch arccos draw
    (trainer.py:286-288).  ``noise``: (B, L) uniform masking noise in place
    of the generator's (the tests pass in the numbers the JAX step draws).

    ``metrics['loss']`` is the mean over the microbatches, a 0-d tensor on
    the device (reading it is the caller's synchronisation).  For the MoE
    versions the metrics also carry ``lb loss``, ``router z``, ``dropped``
    and the (E,) ``expert load``, each the mean over the microbatches.

    ``transformer_apply(transformer, x, context, backend=, generator=,
    remat=)`` replaces the transformer's forward (the pipeline-parallel
    apply, ``parallel.pipeline_parallel.transformer_apply_for``).  ``mesh``:
    data parallelism over its 'data' axis (``imgs``, ``context`` and
    ``noise`` this rank's rows, ``parallel.mesh.shard_batch``); ``grad_sync``
    its ``GradSync`` (ZeRO-1), else plain data parallelism (with the
    pre-pipeline gradients summed over the stages when
    ``transformer_apply`` pipelines)."""
    if transformer_apply is not None and mesh is None:
        raise ValueError('transformer_apply (a pipelined transformer) needs '
                         'mesh=')
    if state is None:
        state = init_pipeline_train_state(pipe, optimizer, ema_decay)
    if (ema_decay is None) != ('ema' not in state):
        raise ValueError('ema_decay must be given to both '
                         'init_pipeline_train_state and the step')
    if state['opt'] is not optimizer:
        raise ValueError('state was initialised with another optimizer')
    params = pipe.trainable_parameters()
    ranks = _DataRanks(mesh)
    pipe_sum = ()
    if transformer_apply is not None:
        from ..parallel.pipeline_parallel import pp_input_params
        pipe_sum = pp_input_params(pipe)
    grad_sync = _grad_sync(params, optimizer, mesh, grad_sync, pipe_sum)
    # a pipelined MoE routes per microbatch, as inside JAX's shard_map
    routed = transformer_apply is None

    def step(imgs, context, mask_ratio, noise=None):
        b = imgs.shape[0]
        if b % grad_accum:
            raise ValueError(f'batch size {b} not divisible by '
                             f'grad_accum_steps={grad_accum}')
        with annotate('pm.train.update', batch=b):
            return update(imgs, context, mask_ratio, noise)

    def update(imgs, context, mask_ratio, noise):
        pipe.train()
        _zero_grads(optimizer, params, grad_sync)
        chunks = [imgs.chunk(grad_accum),
                  context.chunk(grad_accum) if context is not None
                  else [None] * grad_accum,
                  noise.chunk(grad_accum) if noise is not None
                  else [None] * grad_accum]
        loss_sum, aux_sum = 0.0, {}
        with ranks.routing(pipe.transformer) if routed \
                else contextlib.nullcontext():
            for img, ctx, nz in zip(*chunks):
                with ranks.rows(img.shape[0]):
                    loss, aux = pl.pipeline_loss(
                        pipe, _cast(img, compute_dtype),
                        _cast(ctx, compute_dtype), mask_ratio,
                        generator=state['generator'], noise=nz,
                        backend=backend, vq_backend=vq_backend, remat=remat,
                        return_aux=True, transformer_apply=transformer_apply)
                with annotate('pm.train.backward'):
                    loss.backward()
                loss_sum = loss_sum + loss.detach()
                aux_sum = {n: aux_sum.get(n, 0.0) + v for n, v in aux.items()}
        # a parameter the batch did not reach (context_proj when the text
        # was dropped) gets a zero gradient: its moments and its weight
        # decay still advance, as in optax
        with annotate('pm.train.optimizer'):
            _update(optimizer, params, grad_accum, grad_sync)
        state['step'] += 1
        if ema_decay is not None:
            _ema_update(state['ema'], params, ema_decay)
        return ranks.mean({'loss': loss_sum / grad_accum,
                           **{n: v * (1.0 / grad_accum)
                              for n, v in aux_sum.items()}})

    step.state = state
    step.grad_sync = grad_sync
    return step
