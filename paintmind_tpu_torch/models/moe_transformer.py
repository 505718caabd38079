"""MoE stage-2 transformer (``paintmind_tpu/models/moe_transformer.py``):
the conditional bidirectional MaskGIT backbone of ``CondTransformer`` with
every block's SwiGLU replaced by a routed expert pool (``nn/moe.py``).
The versions ``paintmindv1-moe`` (8 experts) and ``paintmindv1-moe-4e``
(4 experts) have paintmindv1's dims and top-2 routing at capacity factor
1.25.  The forward returns ``(logits, aux)``: aux carries the routing
losses averaged over the depth, which the training loss weights by
``lb_weight`` and ``zloss_weight``."""

from __future__ import annotations

import dataclasses

import torch

from ..nn.moe import StackedLinear, make_moe_stack, moe_stack_apply
from .transformer import CondTransformer, CondTransformerConfig


@dataclasses.dataclass(frozen=True)
class MoECondTransformerConfig(CondTransformerConfig):
    num_experts: int = 8
    num_selected: int = 2
    capacity_factor: float = 1.25
    lb_weight: float = 0.01     # Switch load-balance loss weight
    zloss_weight: float = 1e-3  # router z-loss weight
    moe_dispatch: str = 'auto'  # 'auto' | 'gather' | 'dense' (nn/moe.py)


class MoECondTransformer(CondTransformer):
    """``CondTransformer``'s parameter names, with ``layers`` a stack of
    ``MoEBlock``s (``layers.{i}.ffnet.router`` and
    ``layers.{i}.ffnet.experts.{w12,w3}``)."""

    @staticmethod
    def _make_layers(cfg, **kw):
        return make_moe_stack(cfg.depth, cfg.dim, dim_head=cfg.dim_head,
                              mlp_dim=cfg.mlp_dim, num_head=cfg.num_head,
                              num_experts=cfg.num_experts,
                              num_selected=cfg.num_selected,
                              capacity_factor=cfg.capacity_factor,
                              dispatch=cfg.moe_dispatch, context_dim=cfg.dim,
                              dropout=cfg.dropout, **kw)

    @torch.no_grad()
    def init_weights_(self, generator):
        super().init_weights_(generator)
        for m in self.modules():
            if isinstance(m, StackedLinear):
                m.init_weights_(generator)

    def forward(self, x, context=None, *, backend=None, generator=None,
                remat=False):
        """x: (B, len_seq, in_dim); context (B, M, context_dim) or None (the
        cross-attention self-attends).  Returns ``(logits, aux)``.  The
        capacity counts every token of the call, so a row's logits depend on
        the other rows of its batch."""
        x, context = self.embed(x, context)
        x, aux = moe_stack_apply(self.layers, self._seq_split(x), context,
                                 backend=backend, generator=generator,
                                 remat=remat)
        return self.head_project(self._seq_gather(self.norm(x))), aux


def moe_masked_loss(transformer, tokens, labels, mask, context=None, *,
                    generator=None, backend=None, label_smoothing=0.1):
    """The masked MaskGIT cross-entropy with label smoothing (the JAX
    function's soft-target form) plus the weighted routing losses.  Returns
    ``(loss, metrics)`` with metrics ``ce`` and the aux values.  Dropout
    follows the transformer's training mode."""
    cfg = transformer.cfg
    logits, aux = transformer(tokens, context, backend=backend,
                              generator=generator)
    n = cfg.num_classes
    soft = torch.nn.functional.one_hot(labels.long(), n).float()
    soft = soft * (1.0 - label_smoothing) + label_smoothing / n
    ce = -(soft * torch.log_softmax(logits.float(), dim=-1)).sum(-1)
    m = mask.float()
    ce_loss = (ce * m).sum() / m.sum().clamp_min(1.0)
    loss = (ce_loss + cfg.lb_weight * aux['lb_loss']
            + cfg.zloss_weight * aux['router_z'])
    return loss, {'ce': ce_loss, **aux}
