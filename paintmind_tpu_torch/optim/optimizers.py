"""Optimizers with the reference's choices (``paintmind_tpu/optim/optimizers.py``):

  * Adam(betas=(0.9, 0.99)): the stage-1 optimizers;
  * AdamW(betas=(0.9, 0.96), weight decay 0.05): a stage-2 option;
  * Lion: the stage-2 default, here a ``torch.optim.Optimizer`` with optax's
    order of operations.

The functions ``adam``, ``adamw`` and ``lion`` take the parameters to train (only those: a frozen tower's
parameters are not handed over), a learning rate or a ``count -> rate``
schedule, and an optional ``max_grad_norm``.  What they return steps like any
``torch.optim.Optimizer``; with a ``max_grad_norm`` the gradients are first
clipped to that global norm, and with a schedule the rate of update number
``count`` (0 for the first) is written into the parameter groups before it.
Under a mesh the trainers set ``clip_fn`` to the norm over the mesh
(``parallel.data_parallel.clip_by_global_norm``: each carved or sliced
tensor counted once across its group).
"""

from __future__ import annotations

import torch


class Lion(torch.optim.Optimizer):
    """Sign-momentum update with decoupled weight decay, in optax's order:

        p ← p − lr·(sign(β1·m + (1−β1)·g) + wd·p),  then  m ← β2·m + (1−β2)·g
    """

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group['lr'], group['weight_decay']
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['exp_avg'] = torch.zeros_like(p)
                m = state['exp_avg']
                direction = torch.sign(m * b1 + p.grad * (1.0 - b1))
                p.sub_(lr * (direction + wd * p))
                m.mul_(b2).add_(p.grad, alpha=1.0 - b2)
        return loss


def _scheduled(cls):
    """``cls`` with global-norm clipping and a scheduled learning rate in
    front of its update (optax's ``chain(clip_by_global_norm, tx)``)."""

    class Scheduled(cls):
        def __init__(self, params, learning_rate, max_grad_norm=None, **kw):
            self.schedule = learning_rate if callable(learning_rate) else None
            lr = learning_rate(0) if self.schedule else learning_rate
            super().__init__(params, lr=lr, **kw)
            self.max_grad_norm = max_grad_norm
            self.clip_fn = None  # None: torch.nn.utils.clip_grad_norm_
            self.count = 0  # updates taken; saved in the state dict

        @torch.no_grad()
        def step(self, closure=None):
            params = [p for g in self.param_groups for p in g['params']
                      if p.grad is not None]
            if self.max_grad_norm is not None:
                clip = self.clip_fn or torch.nn.utils.clip_grad_norm_
                clip(params, self.max_grad_norm)
            if self.schedule is not None:
                for group in self.param_groups:
                    group['lr'] = self.schedule(self.count)
            self.count += 1
            return super().step(closure)

        def state_dict(self):
            return {**super().state_dict(), 'count': self.count}

        def load_state_dict(self, state_dict):
            state_dict = dict(state_dict)
            self.count = state_dict.pop('count')
            super().load_state_dict(state_dict)

    Scheduled.__name__ = Scheduled.__qualname__ = cls.__name__
    return Scheduled


_Adam, _AdamW, _Lion = (_scheduled(c) for c in
                        (torch.optim.Adam, torch.optim.AdamW, Lion))


def adam(params, learning_rate, betas=(0.9, 0.99), max_grad_norm=None):
    return _Adam(params, learning_rate, max_grad_norm, betas=betas, eps=1e-8)


def adamw(params, learning_rate, betas=(0.9, 0.96), weight_decay=0.05,
          max_grad_norm=None):
    return _AdamW(params, learning_rate, max_grad_norm, betas=betas,
                  eps=1e-8, weight_decay=weight_decay)


def lion(params, learning_rate, betas=(0.9, 0.99), weight_decay=0.0,
         max_grad_norm=None):
    return _Lion(params, learning_rate, max_grad_norm, betas=betas,
                 weight_decay=weight_decay)
