"""Warmup + cosine learning-rate schedule
(``paintmind_tpu/optim/lr_scheduler.py``), the reference's timm
CosineLRScheduler with ``warmup_prefix=True``, ``t_in_epochs=False``,
``cycle_limit=1``, stepped per iteration:

  t <  warmup_t:  lr = warmup_lr_init + t · (lr − warmup_lr_init)/warmup_t
  t >= warmup_t:  t' = t − warmup_t
                  t' < decay: lr_min + 0.5·(lr − lr_min)·(1 + cos(π·t'/decay))
                  else:       lr_min

Plain Python on the host: the trainer reads one value per update and writes
it into the optimizer's parameter groups.
"""

from __future__ import annotations

import math


def build_schedule(lr, lr_min, warmup_steps, warmup_lr_init, decay_steps):
    """Returns a ``step -> learning rate`` callable."""
    lr = float(lr)
    lr_min = float(lr_min)
    warmup_steps = int(warmup_steps)
    decay_steps = int(decay_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return warmup_lr_init + step * (lr - warmup_lr_init) / warmup_steps
        t = step - warmup_steps
        if t >= decay_steps:
            return lr_min
        frac = t / max(decay_steps, 1)
        return lr_min + 0.5 * (lr - lr_min) * (1.0 + math.cos(math.pi * frac))

    return schedule


def build_scheduler(num_epoch, iters_per_epoch, lr, lr_min, warmup_steps,
                    warmup_lr_init, decay_steps=None):
    """The reference's ``build_scheduler`` signature: ``decay_steps``
    defaults to ``num_epoch · iters_per_epoch``."""
    if decay_steps is None:
        decay_steps = num_epoch * iters_per_epoch
    return build_schedule(lr, lr_min, warmup_steps, warmup_lr_init, decay_steps)
