"""PatchGAN discriminator (``paintmind_tpu/models/discriminator.py``).

The reference NLayerDiscriminator (paintmind/stage1/discriminator.py:14-71):
4×4 convolutions, stride 2 for the first ``n_layers`` and 1 after, ``ndf``
channels doubling up to 8×, BatchNorm + LeakyReLU(0.2) between them, a
one-channel map of patch logits at the end; N(0, 0.02) convolution weights,
BatchNorm scale N(1, 0.02).  Images are NHWC at the public functions, as in
the JAX package; the convolutions run in NCHW (cuDNN on the card, in fp32).

BatchNorm in training mode normalises with the batch's statistics and moves
the running ones with momentum 0.1 and the unbiased variance; in eval mode
it uses the running ones.  It is written out (``_batch_norm``) rather than
taken from ``F.batch_norm`` so that it computes what the JAX package's
``_batchnorm`` computes, in fp32, and so that the gradient penalty's double
backward runs through plain autograd.  Every forward in training mode moves
the running statistics once: the train step decides the order (D on the
fakes, the reals, the interpolates, then the G phase), as the JAX package
threads its ``stats`` through those calls.

The discriminator has no attention, so no once-differentiable kernel lies on
the gradient penalty's double backward.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import sum_replicated


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 3


class _BatchNorm(nn.Module):
    """Per-channel scale and bias with running mean and variance buffers."""

    def __init__(self, c, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer('running_mean', torch.zeros(c, device=device))
        self.register_buffer('running_var', torch.ones(c, device=device))


def _batch_norm(bn, x, train, momentum=0.1, eps=1e-5, group=None):
    """x: (B, C, H, W).  Train: batch statistics, and the running ones moved
    in place (``(1 − m)·running + m·batch``, the variance unbiased); eval:
    the running ones.  fp32 inside, the input's type out.  ``group``: the
    data-parallel group whose ranks' rows form the batch (sync-BN: the
    statistics of the global batch, as the JAX package's discriminator
    computes them on the global array)."""
    x32 = x.float()
    if train and group is not None:
        n = x.shape[0] * x.shape[2] * x.shape[3] * dist.get_world_size(group)
        mean = sum_replicated(x32.sum(dim=(0, 2, 3)), group) / n
        var = sum_replicated(torch.square(
            x32 - mean.view(1, -1, 1, 1)).sum(dim=(0, 2, 3)), group) / n
    elif train:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), correction=0)
        n = x.shape[0] * x.shape[2] * x.shape[3]
    if train:
        with torch.no_grad():
            bn.running_mean.mul_(1 - momentum).add_(momentum * mean)
            bn.running_var.mul_(1 - momentum).add_(
                momentum * var * (n / max(n - 1, 1)))
    else:
        mean, var = bn.running_mean, bn.running_var
    shape = (1, -1, 1, 1)
    y = ((x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
         * bn.weight.view(shape) + bn.bias.view(shape))
    return y.to(x.dtype)


class _Layer(nn.Module):
    def __init__(self, cin, cout, *, bias, norm, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 4, padding=1, bias=bias,
                              device=device)
        self.bn = _BatchNorm(cout, device=device) if norm else None


class Discriminator(nn.Module):
    """``layers[i]`` holds ``conv`` and, between the first and the last,
    ``bn``: the JAX package's ``params[i]`` / ``stats[i]``.  Like the JAX
    package's ``discriminator_apply``, ``forward`` takes the BatchNorm mode
    as an argument (the module's own training flag is not read)."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(), *,
                 seed=0, device='cuda'):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device)
        layers = [_Layer(cfg.input_nc, cfg.ndf, bias=True, norm=False, **kw)]
        nf_mult = 1
        for n in range(1, cfg.n_layers):  # stride 2, BatchNorm, no conv bias
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers.append(_Layer(cfg.ndf * nf_prev, cfg.ndf * nf_mult,
                                 bias=False, norm=True, **kw))
        nf_prev, nf_mult = nf_mult, min(2 ** cfg.n_layers, 8)
        layers.append(_Layer(cfg.ndf * nf_prev, cfg.ndf * nf_mult, bias=False,
                             norm=True, **kw))
        layers.append(_Layer(cfg.ndf * nf_mult, 1, bias=True, norm=False, **kw))
        self.layers = nn.ModuleList(layers)
        self.sync_group = None  # data parallelism: global batch statistics
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, g):
        """In the JAX package's order: per layer the conv kernel ~ N(0,
        0.02), then the BatchNorm scale ~ N(1, 0.02); biases 0."""
        for layer in self.layers:
            layer.conv.weight.normal_(generator=g).mul_(0.02)
            if layer.conv.bias is not None:
                layer.conv.bias.zero_()
            if layer.bn is not None:
                layer.bn.weight.normal_(generator=g).mul_(0.02).add_(1.0)
                layer.bn.bias.zero_()

    @property
    def device(self):
        return self.layers[0].conv.weight.device

    def forward(self, x, train=True):
        """x: (B, H, W, C) in [-1, 1] -> (B, h', w', 1) patch logits.  In
        training mode every BatchNorm moves its running statistics once."""
        x = x.permute(0, 3, 1, 2)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            stride = 2 if i < self.cfg.n_layers else 1
            w = layer.conv.weight.to(x.dtype)
            b = None if layer.conv.bias is None else layer.conv.bias.to(x.dtype)
            x = F.conv2d(x, w, b, stride=stride, padding=1)
            if layer.bn is not None:
                x = _batch_norm(layer.bn, x, train, group=self.sync_group)
            if i < last:
                x = F.leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)


def hinge_d_loss(fake, real):
    """(reference trainer.py:26-30)."""
    return 0.5 * (torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake)))


def g_nonsaturating_loss(fake):
    """(reference trainer.py:33-36)."""
    return torch.mean(F.softplus(-fake))


def gradient_penalty(disc, real, fake, eta, lambda_term=10.0):
    """WGAN-GP on interpolates (reference trainer.py:153-169): ``eta`` is
    the per-sample (B, 1, 1, 1) mix in [0, 1) (drawn by the caller, so that
    a test can pass the JAX package's draw); the gradient of sum(D(interp))
    with respect to interp, its 2-norm over the channels, ((‖g‖ − 1)²)·λ.
    The gradient is taken with ``create_graph=True``, so the penalty
    back-propagates into D's parameters (a double backward through conv,
    BatchNorm and LeakyReLU).  D runs in training mode: its running
    statistics move once."""
    interp = (eta * real + (1.0 - eta) * fake).detach().requires_grad_(True)
    out = disc(interp, train=True)
    (grads,) = torch.autograd.grad(out.sum(), interp, create_graph=True)
    norm = torch.sqrt(torch.sum(torch.square(grads.float()), dim=-1) + 1e-12)
    return torch.mean(torch.square(norm - 1.0)) * lambda_term


def convert_discriminator(sd, cfg: DiscriminatorConfig = DiscriminatorConfig()):
    """A reference NLayerDiscriminator ``state_dict`` (torch Sequential
    indices ``model.<i>``: conv, leaky; then per block conv, bn, leaky; the
    final conv) -> this module's ``state_dict``.  The layouts agree (OIHW),
    only the names move."""
    out = {}
    idx = 0
    for i in range(cfg.n_layers + 2):
        first_or_last = i in (0, cfg.n_layers + 1)
        out[f'layers.{i}.conv.weight'] = sd[f'model.{idx}.weight']
        if first_or_last:
            out[f'layers.{i}.conv.bias'] = sd[f'model.{idx}.bias']
            idx += 2
        else:
            bn = f'model.{idx + 1}'
            out[f'layers.{i}.bn.weight'] = sd[f'{bn}.weight']
            out[f'layers.{i}.bn.bias'] = sd[f'{bn}.bias']
            out[f'layers.{i}.bn.running_mean'] = sd[f'{bn}.running_mean']
            out[f'layers.{i}.bn.running_var'] = sd[f'{bn}.running_var']
            idx += 3
    return {k: torch.as_tensor(v) for k, v in out.items()}
