"""Train steps (``paintmind_tpu/train/steps.py``), the stage-2 half.

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

The stage-1 adversarial step is not ported yet (ROADMAP queue A, 7b).
"""

from __future__ import annotations

import torch

from ..models import pipeline as pl
from ..models.pipeline import _not_ported


def _cast(x, dtype):
    return x if dtype is None or x is None else x.to(dtype)


@torch.no_grad()
def _ema_update(ema, new, decay):
    """``decay·ema + (1 − decay)·new``, in place on the ``ema`` tensors."""
    for e, p in zip(ema, new):
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


def init_pipeline_train_state(pipe, optimizer, ema_decay=None, seed=0):
    """The mutable training state around ``pipe``: the update count, the
    optimizer, the generator that feeds masking noise and dropout, and (with
    ``ema_decay``) an EMA copy of the trainable tensors only, in the order
    of ``pipe.trainable_parameters()``.  Marks those parameters trainable.
    They are the master weights, so they must be fp32: a pipeline built with
    a ``compute_dtype`` holds its weights in that type and is for sampling."""
    params = pipe.trainable_parameters()
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError('training updates fp32 master weights: build the '
                         'Pipeline with compute_dtype=None (the step casts '
                         'the activations, not the weights)')
    for p in params:
        p.requires_grad_(True)
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
                             state=None, transformer_apply=None):
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
    the device (reading it is the caller's synchronisation)."""
    if pipe.config.num_experts:
        raise _not_ported('MoE routing losses in the train step', 8)
    if transformer_apply is not None:
        raise _not_ported('a pipeline-parallel transformer_apply', 10)
    if state is None:
        state = init_pipeline_train_state(pipe, optimizer, ema_decay)
    if (ema_decay is None) != ('ema' not in state):
        raise ValueError('ema_decay must be given to both '
                         'init_pipeline_train_state and the step')
    if state['opt'] is not optimizer:
        raise ValueError('state was initialised with another optimizer')
    params = pipe.trainable_parameters()

    def step(imgs, context, mask_ratio, noise=None):
        b = imgs.shape[0]
        if b % grad_accum:
            raise ValueError(f'batch size {b} not divisible by '
                             f'grad_accum_steps={grad_accum}')
        pipe.train()
        optimizer.zero_grad(set_to_none=True)
        chunks = [imgs.chunk(grad_accum),
                  context.chunk(grad_accum) if context is not None
                  else [None] * grad_accum,
                  noise.chunk(grad_accum) if noise is not None
                  else [None] * grad_accum]
        loss_sum = 0.0
        for img, ctx, nz in zip(*chunks):
            loss = pl.pipeline_loss(
                pipe, _cast(img, compute_dtype), _cast(ctx, compute_dtype),
                mask_ratio, generator=state['generator'], noise=nz,
                backend=backend, vq_backend=vq_backend, remat=remat)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        for p in params:
            if p.grad is None:
                # a parameter the batch did not reach (context_proj when the
                # text was dropped) has a zero gradient, not none: its
                # moments and its weight decay still advance, as in optax
                p.grad = torch.zeros_like(p)
            elif grad_accum > 1:
                p.grad.mul_(1.0 / grad_accum)
        optimizer.step()
        state['step'] += 1
        if ema_decay is not None:
            _ema_update(state['ema'], params, ema_decay)
        return {'loss': loss_sum / grad_accum}

    step.state = state
    return step
