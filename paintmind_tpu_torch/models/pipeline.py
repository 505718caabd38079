"""Stage-2 MaskGIT pipeline (``paintmind_tpu/models/pipeline.py``): frozen
VQGAN + conditional transformer, with the training loss and iterative
parallel decoding.

  * training forward (``pipeline_loss``): encode the image with the frozen
    VQGAN -> per-sample random masking -> transformer -> masked
    cross-entropy with label smoothing 0.1 (reference generate.py:110-146);
  * ``generate``: cosine-schedule confidence re-masking (reference
    generate.py:159-198) as a Python loop of ``sample_step``s, then
    ``decode_from_indice`` for the steps asked for;
  * ``paint`` / ``inpaint`` / ``outpaint``: the same loop seeded with a
    latent keep-mask, with the re-mask clamped to the masked count;
  * classifier-free guidance ``uncond + s·(cond − uncond)``, mixed on the
    post-LN hidden states before the shared vocab head; scalar or per-sample
    (B,) scales and temperatures.

Each step's sampling head is kernel K3 (``ops/sampling``) on the card
('fused' sampler) and the reference math on the CPU ('exact' sampler).
Randomness comes from ``torch.Generator``s; the exact sampler also takes
explicit per-step Gumbel ``noise``, which is how the tests feed it the noise
the JAX package draws.

Conditioning: ``embed_text`` takes prompts, token ids or conditioning
images through the pipeline's tower (``models/t5.py``, ``models/clip.py``),
or precomputed (B, M, t5_dim) contexts.  Not ported yet: the MoE,
pipeline-parallel and int8 branches (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch
from torch import nn

from ..config import Config, ver2cfg
from ..ops.sampling import fused_gumbel_topk_sample
from ..ops.sampling import gumbel_noise as _gumbel
from . import vqmodel as vm
from .quantize import l2norm
from .transformer import CondTransformer, CondTransformerConfig

# Conditioning towers the registry's ``t5`` field can name -> context dim.
CONTEXT_TOWERS = {
    't5-l': 1024, 't5-xl': 2048, 't5-xxl': 4096,
    'clip-l': 768, 'clip-l-penultimate': 768,
    'clip-img-l': 1024,
}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stage1: str = 'vit-s-vqgan'
    t5: str = 't5-l'
    dim: int = 1024
    dim_head: int = 64
    mlp_dim: int = 4096
    num_head: int = 16
    depth: int = 12
    dropout: float = 0.1
    vqc: vm.VQModelConfig = vm.VQModelConfig()
    t5_dim: int = 1024
    normalize_sample_tokens: bool = False
    num_experts: int = 0  # > 0: the MoE variant, not ported yet

    @classmethod
    def from_dict(cls, d):
        d = d if isinstance(d, dict) else d.to_dict()
        return cls(stage1=d['stage1'], t5=d['t5'], dim=d['dim'],
                   dim_head=d['dim_head'], mlp_dim=d['mlp_dim'],
                   num_head=d['num_head'], depth=d['depth'],
                   dropout=d['dropout'],
                   vqc=vm.VQModelConfig.from_dict(ver2cfg[d['stage1']]),
                   t5_dim=CONTEXT_TOWERS[d['t5']],
                   normalize_sample_tokens=d.get('normalize_sample_tokens',
                                                 False),
                   num_experts=d.get('num_experts', 0))

    @property
    def image_size(self):
        return self.vqc.enc.image_size

    @property
    def patch_size(self):
        return self.vqc.enc.patch_size

    @property
    def num_tokens(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def mask_token_id(self):
        return self.vqc.n_embed

    @property
    def tcfg(self) -> CondTransformerConfig:
        return CondTransformerConfig(
            in_dim=self.vqc.embed_dim, dim=self.dim, len_seq=self.num_tokens,
            dim_head=self.dim_head, mlp_dim=self.mlp_dim,
            num_head=self.num_head, depth=self.depth, dropout=self.dropout,
            context_dim=self.t5_dim, num_classes=self.vqc.n_embed)


# ---------------------------------------------------------------------------
# Training-path functions
# ---------------------------------------------------------------------------

def random_masking(x, mask_token, mask_ratio, *, generator=None, noise=None):
    """Per-sample random masking by rank of uniform noise (reference
    generate.py:78-108).  x: (B, L, D); returns (x_masked, mask) with mask
    1 = replaced by ``mask_token``.  ``noise``: the (B, L) uniform numbers to
    rank, else they are drawn from ``generator`` on x's device.

    The number masked is ``int32(float32(L) * float32(mask_ratio))``, at
    least 1: the product is taken in fp32 as the JAX package takes it, so a
    ratio on a boundary masks the same count."""
    n, l, _ = x.shape
    len_mask = max(int(np.float32(l) * np.float32(mask_ratio)), 1)
    len_keep = l - len_mask
    if noise is None:
        noise = torch.rand(n, l, device=x.device, generator=generator)
    # stable sorts: equal noise values rank in index order, as jnp.argsort
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    rank = torch.argsort(ids_shuffle, dim=1, stable=True)
    keep = rank < len_keep
    x = torch.where(keep[..., None], x, mask_token.to(x.dtype))
    return x, 1.0 - keep.float()


def masked_ce_loss(logits, labels, mask, label_smoothing=0.1):
    """Cross-entropy with label smoothing, averaged over the masked
    positions (reference generate.py:110-123), in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return (per_tok * mask).sum() / mask.sum()


def pipeline_loss(pipe, img, context, mask_ratio, *, generator=None,
                  noise=None, backend=None, vq_backend='auto', remat=False):
    """Training forward -> scalar loss (reference generate.py:136-146).
    ``img``: (B, H, W, C) in [-1, 1], in the compute type; ``context``: the
    (B, M, t5_dim) text embedding or None (CFG dropout).  The VQGAN is
    frozen: it encodes under ``no_grad`` (kernel K2 inside) and ``z_q`` is
    detached, so the gradient reaches ``mask_token`` through the masking
    ``where`` and the transformer through its logits.  Dropout follows the
    transformer's training mode and draws from ``generator``, after the
    masking noise (or only the dropout masks, when ``noise`` is given)."""
    with torch.no_grad():
        z_q, _, ids = pipe.vqgan.encode(img, backend=backend,
                                        vq_backend=vq_backend)
    x, mask = random_masking(z_q.detach(), pipe.mask_token, mask_ratio,
                             generator=generator, noise=noise)
    logits = pipe.transformer(x, context, backend=backend,
                              generator=generator, remat=remat)
    return masked_ce_loss(logits, ids, mask)


# ---------------------------------------------------------------------------
# Sampling-path functions
# ---------------------------------------------------------------------------

def mask_schedule(ratio):
    return np.cos(math.pi / 2.0 * ratio)  # (reference generate.py:25-26)


def ids_to_tokens(pipe, ids, cfg: PipelineConfig):
    """Gather sampling tokens from [codebook; mask_token]: the **raw**
    codebook rows (reference generate.py:148-157)."""
    codebook = pipe.vqgan.quantize.codebook
    if cfg.normalize_sample_tokens:
        codebook = l2norm(codebook)
    table = torch.cat([codebook, pipe.mask_token.to(codebook.dtype)], dim=0)
    return table[ids.long()]


def _topk_filter(logits, k):
    """Keep the logits >= the k-th largest per position, others -> -inf
    (reference top_k, generate.py:33-37): ties at the threshold are all
    kept, so more than k may survive."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits,
                       torch.full((), -math.inf, dtype=logits.dtype,
                                  device=logits.device))


def _transformer_logits(pipe, tokens, context, guidance_scale, *, cfg,
                        backend=None, dtype=None, neg_context=None):
    if dtype is not None:
        tokens = tokens.to(dtype)
        context = context.to(dtype) if context is not None else None
        neg_context = (neg_context.to(dtype)
                       if neg_context is not None else None)
    tr = pipe.transformer
    if guidance_scale is None or context is None:
        return tr(tokens, context, backend=backend)
    b = tokens.shape[0]
    scale = torch.as_tensor(guidance_scale, device=tokens.device).to(tokens.dtype)
    if scale.ndim == 1:  # per-sample (B,)
        scale = scale[:, None, None]
    both = torch.cat([tokens, tokens], dim=0) if b <= 8 else None
    if neg_context is not None:
        # negative-prompt guidance: the unguided branch attends to the
        # negative caption; one 2B pass while the batch is small
        if both is not None:
            hid = tr(both, torch.cat([context, neg_context], dim=0),
                     backend=backend, return_hidden=True)
            cond, uncond = hid[:b], hid[b:]
        else:
            cond = tr(tokens, context, backend=backend, return_hidden=True)
            uncond = tr(tokens, neg_context, backend=backend,
                        return_hidden=True)
    elif both is not None:
        # fused CFG: one 2B pass, cross-attention split into its two shapes
        hid = tr(both, context, backend=backend, cfg_halves=True,
                 return_hidden=True)
        cond, uncond = hid[:b], hid[b:]
    else:
        cond = tr(tokens, context, backend=backend, return_hidden=True)
        uncond = tr(tokens, None, backend=backend, return_hidden=True)
    # guidance is affine and the head is one linear map for both branches,
    # so mixing the hidden states before it equals mixing the logits
    return tr.head_project(uncond + scale * (cond - uncond))


def sample_step(pipe, ids, *, context, n_masked, temperature, topk,
                cfg: PipelineConfig, guidance_scale=None, backend=None,
                dtype=None, sampler='auto', neg_context=None,
                clamp_remask=False, noise=None, generator=None):
    """One MaskGIT step (reference Pipeline.sample, generate.py:159-181).
    Returns (ids_next, pred_ids).

    sampler: 'exact' = the reference math (top-k threshold filter, Gumbel
    argmax, softmax confidence), with ``noise`` (B, L, V) if given, else
    Gumbel noise from ``generator``; 'fused' = kernel K3 (one pass over the
    logits, seeded from ``generator``); 'auto' = fused for CUDA logits,
    exact for CPU logits."""
    b, l = ids.shape
    tokens = ids_to_tokens(pipe, ids, cfg)
    logits = _transformer_logits(pipe, tokens, context, guidance_scale,
                                 cfg=cfg, backend=backend, dtype=dtype,
                                 neg_context=neg_context)
    if sampler == 'auto':
        sampler = 'fused' if logits.is_cuda else 'exact'
    is_mask = ids == cfg.mask_token_id
    if sampler == 'fused':
        if noise is not None:
            raise ValueError('noise is an input of the exact sampler; the '
                             'fused sampler draws its own from generator')
        pred_ids, conf = fused_gumbel_topk_sample(logits, temperature, topk,
                                                  generator=generator)
        pred_ids = pred_ids.to(ids.dtype)
    elif sampler == 'exact':
        filtered = _topk_filter(logits, topk).float()
        temp = torch.clamp(torch.as_tensor(temperature, dtype=torch.float32,
                                           device=logits.device), min=1e-10)
        if temp.ndim == 1:  # per-sample (B,) -> (B, 1, 1)
            temp = temp[:, None, None]
        if noise is None:
            noise = _gumbel(filtered.shape, generator=generator,
                            device=logits.device)
        pred_ids = torch.argmax(filtered / temp + noise, dim=-1).to(ids.dtype)
        probs = torch.softmax(logits.float(), dim=-1)
        conf = torch.gather(probs, -1, pred_ids.long()[..., None])[..., 0]
    else:
        raise ValueError(f"sampler must be 'auto', 'fused' or 'exact', got "
                         f'{sampler!r}')

    ids_filled = torch.where(is_mask, pred_ids, ids)
    scores = torch.where(is_mask, 1.0 - conf,
                         torch.full((), -1e5, device=ids.device))
    # re-mask the n_masked lowest-confidence masked positions.  The
    # reference's -1e5 sentinel (not -inf) lets kept tokens be re-masked
    # when n_masked exceeds the masked count; clamp_remask (the paint path)
    # clamps it to each sample's masked count instead.
    if clamp_remask:
        n_masked = torch.clamp(is_mask.sum(dim=1), max=int(n_masked))
        n_masked = n_masked.reshape(-1, 1)
    remask = _remask_by_rank if l <= 2048 else _remask_by_sort
    return remask(scores, ids_filled, n_masked, cfg.mask_token_id), pred_ids


def _remask_by_rank(scores, ids_filled, n_masked, mask_token_id):
    """Mask the ``n_masked`` highest scores per row (ties: lower index
    first) by each element's rank, #{j: s_j > s_i} + #{j < i: s_j == s_i}:
    one all-pairs compare, O(L²), for L <= 2048."""
    l = scores.shape[1]
    si = scores[:, :, None]
    sj = scores[:, None, :]
    idx = torch.arange(l, device=scores.device)
    before = idx[None, None, :] < idx[None, :, None]
    rank = ((sj > si) | ((sj == si) & before)).sum(dim=-1)
    return torch.where(rank < n_masked,
                       torch.full((), mask_token_id, dtype=ids_filled.dtype,
                                  device=ids_filled.device), ids_filled)


# calls of the sort route, which only the 512² variant (L = 4096) takes;
# the smoke run reads it to show that route ran on the card
sort_remasks = 0


def _remask_by_sort(scores, ids_filled, n_masked, mask_token_id):
    """The same re-mask by a stable descending sort (``torch.topk`` does not
    promise lower-index-first on ties), for L > 2048."""
    global sort_remasks
    sort_remasks += 1
    l = scores.shape[1]
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    ranked = torch.gather(ids_filled, 1, order)
    first = torch.arange(l, device=scores.device)[None, :] < n_masked
    new = torch.where(first, torch.full((), mask_token_id,
                                        dtype=ids_filled.dtype,
                                        device=ids_filled.device), ranked)
    return ids_filled.scatter(1, order, new)


def _schedule_arrays(timesteps, temperature, num_tokens):
    """Per-step re-mask counts (numpy int32 (T,)) and temperatures (fp32
    (T,) or, for per-sample (B,) base temperatures, (T, B))."""
    steps = np.arange(1, timesteps + 1)
    masked_r = mask_schedule(steps / timesteps)
    n_masked = np.maximum((masked_r * num_tokens).astype(np.int32), 1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    factor = torch.as_tensor(
        np.asarray(1.0 - (steps - 1) / timesteps, np.float32),
        device=temperature.device)
    if temperature.ndim == 0:
        temps = temperature * factor
    else:
        temps = temperature[None, :] * factor[:, None]
    return n_masked, temps


@torch.no_grad()
def generate_ids(pipe, init_ids, context=None, *, cfg: PipelineConfig,
                 timesteps=18, temperature=1.0, topk=5, guidance_scale=None,
                 backend=None, dtype=None, sampler='auto', cfg_warmup=0.0,
                 neg_context=None, clamp_remask=False, trajectory='merged',
                 noise=None, generator=None):
    """The full iterative decode (reference generate.py:183-198).  Returns
    (final ids, per-step display ids (T, B, L)): ``trajectory='merged'``
    gives committed tokens plus the current prediction at still-masked
    slots, ``'preds'`` the raw per-step predictions.

    ``cfg_warmup``: fraction of the early steps that run conditional-only
    before guidance starts.  ``noise``: per-step Gumbel noise (T, B, L, V)
    for the exact sampler."""
    if trajectory not in ('merged', 'preds'):
        raise ValueError(f"trajectory must be 'merged' or 'preds', "
                         f'got {trajectory!r}')
    device = init_ids.device
    n_masked, temps = _schedule_arrays(timesteps, temperature, cfg.num_tokens)
    temps = temps.to(device)  # once, not one host copy per step
    if guidance_scale is not None:
        guidance_scale = torch.as_tensor(guidance_scale, dtype=torch.float32,
                                         device=device)
    warm = 0
    if guidance_scale is not None and context is not None and cfg_warmup:
        warm = min(int(round(cfg_warmup * timesteps)), timesteps)

    ids = init_ids
    shown = []
    for t in range(timesteps):
        ids, pred = sample_step(
            pipe, ids, context=context, n_masked=int(n_masked[t]),
            temperature=temps[t], topk=topk, cfg=cfg,
            guidance_scale=None if t < warm else guidance_scale,
            backend=backend, dtype=dtype, sampler=sampler,
            neg_context=neg_context, clamp_remask=clamp_remask,
            noise=None if noise is None else noise[t], generator=generator)
        if trajectory == 'preds':
            shown.append(pred)
        else:
            shown.append(torch.where(ids == cfg.mask_token_id, pred, ids))
    return ids, torch.stack(shown)


# ---------------------------------------------------------------------------
# Object API
# ---------------------------------------------------------------------------

def _not_ported(what, item):
    return NotImplementedError(f'{what} is not ported to paintmind_tpu_torch '
                               f'yet (ROADMAP.md, queue A item {item})')


class Pipeline(nn.Module):
    """Frozen VQGAN (``vqgan``) + conditional transformer (``transformer``)
    + ``mask_token``: the parameter tree of ``paintmind_tpu``'s Pipeline.

    ``text_encoder``: the conditioning tower, kept outside the parameter
    tree (a T5TextEncoder, CLIPTextEmbedder or CLIPImageEmbedder, or any
    callable with their contract); ``'auto'`` builds the registry's T5 from
    the local Hugging Face cache at first use and refuses a CLIP tower (no
    trained CLIP weights are reachable offline); ``None`` takes precomputed
    (B, M, t5_dim) contexts only.  Built frozen and in eval mode, with the
    weights in ``compute_dtype`` when one is given (the sampling set-up).  For
    training build it with ``compute_dtype=None`` (fp32 master weights; the
    layers cast them to the activations' type per call):
    ``trainable_parameters()`` are ``transformer`` and ``mask_token``, and
    ``train()`` switches only the transformer, never the VQGAN."""

    def __init__(self, config=None, stage1_pretrained=True,
                 stage1_checkpoint_path=None, *, text_encoder='auto', seed=0,
                 param_dtype=torch.float32, compute_dtype=None, device='cuda'):
        super().__init__()
        if config is None:
            config = Config(ver2cfg['paintmindv1'])
        self.config = (config if isinstance(config, PipelineConfig)
                       else PipelineConfig.from_dict(config))
        cfg = self.config
        if cfg.num_experts:
            raise _not_ported('the MoE stage-2 variant', 8)
        device = vm.resolve_device(device)
        self.compute_dtype = compute_dtype

        from ..factory import create_model
        self.vqgan = create_model(
            'vqgan', cfg.stage1, pretrained=stage1_pretrained,
            checkpoint_path=stage1_checkpoint_path, seed=seed,
            param_dtype=param_dtype, compute_dtype=compute_dtype,
            device=device)
        self.vqgan.freeze()
        self.transformer = CondTransformer(cfg.tcfg, device=device,
                                           dtype=param_dtype)
        self.mask_token = nn.Parameter(torch.empty(
            1, cfg.vqc.embed_dim, device=device, dtype=param_dtype))
        g = vm.make_generator(device, seed)
        self.transformer.init_weights_(g)
        with torch.no_grad():
            self.mask_token.normal_(generator=g).mul_(0.02)
        if compute_dtype is not None:
            self.to(compute_dtype)
        self.requires_grad_(False)
        self.eval()

        # the tower is no submodule: it is not part of the parameter tree
        # (checkpoints, to_flat) and keeps its own device and type
        object.__setattr__(self, 'text_model', None if text_encoder in
                           ('auto', None) else text_encoder)
        self._text_lock = threading.Lock()
        self._text_disabled = text_encoder is None
        self.mask_token_id = cfg.mask_token_id
        self.num_tokens = cfg.num_tokens
        self.image_size = cfg.image_size
        self.patch_size = cfg.patch_size
        self._generator = vm.make_generator(device, seed + 1)

    @property
    def device(self):
        return self.mask_token.device

    def train(self, mode=True):
        """Training mode for the transformer only: the VQGAN stays frozen
        and in eval mode whatever is asked for."""
        self.training = mode
        self.transformer.train(mode)
        self.vqgan.eval()
        return self

    def trainable_parameters(self):
        """``mask_token`` and the transformer's parameters (the VQGAN is
        frozen, reference generate.py:56)."""
        return [self.mask_token, *self.transformer.parameters()]

    def _get_text_model(self):
        if self._text_disabled:
            raise RuntimeError(
                'this pipeline was built with text_encoder=None (text '
                'disabled) — pass precomputed context embeddings, or '
                "construct with text_encoder='auto' or a tower")
        with self._text_lock:  # serving encodes from concurrent threads
            if self.text_model is None:
                tower = self.config.t5
                if tower.startswith('clip'):
                    # a bare CLIP embedder would condition on random
                    # weights, unrelated to the ones the pipeline trained with
                    raise RuntimeError(
                        f'pipeline tower {tower!r} has no pretrained CLIP '
                        'weights reachable offline — pass the trained '
                        'tower explicitly (text_encoder=..., e.g. '
                        'clip.load_image_tower(tower.npz) saved by '
                        'tools/train_imgvar.py, or --tower-checkpoint)')
                from .t5 import T5_VERSIONS, T5TextEncoder
                version, _ = T5_VERSIONS[tower]
                object.__setattr__(self, 'text_model',
                                   T5TextEncoder(version, device=self.device))
        return self.text_model

    def embed_text(self, text):
        """list[str] | (B, M) token ids | (B, H, W, 3) conditioning images
        (clip-img towers) | (B, M, t5_dim) embeddings (numpy or torch) |
        None -> context on this pipeline's device, or None.  The tower runs
        without autograd (a frozen tower; grad mode is per thread, and the
        serving handlers call this from theirs), but outside inference mode:
        training consumes these contexts in a graph."""
        if text is None:
            return None
        if isinstance(text, (list, tuple)) and text and isinstance(text[0], str):
            with torch.no_grad():
                ctx = self._get_text_model()(list(text))
        else:
            ctx = torch.as_tensor(text if isinstance(text, torch.Tensor)
                                  else np.asarray(text))
            if ctx.ndim == 2 and not ctx.is_floating_point():
                tower = self._get_text_model()
                with torch.no_grad():  # CLIP text: __call__ takes the ids
                    ctx = getattr(tower, 'encode_ids', tower)(ctx)
            elif ctx.ndim == 4:  # conditioning images; a context is 3-D
                with torch.no_grad():
                    ctx = self._get_text_model()(ctx)
            elif ctx.ndim != 3 or not ctx.is_floating_point():
                raise ValueError(f'text: prompts, (B, M) token ids, (B, H, W, '
                                 f'3) images or (B, M, D) contexts, got a '
                                 f'{ctx.ndim}-D {ctx.dtype} array')
        ctx = ctx.to(self.device)
        return ctx.float() if ctx.dtype == torch.float64 else ctx

    def to_latent(self, img, text=None):
        z, _, ids = self.vqgan.encode(img)
        return z, ids, self.embed_text(text)

    # -- training --------------------------------------------------------

    def tokens2logits(self, tokens, context=None):
        tokens = torch.as_tensor(tokens, device=self.device)
        return self.transformer(tokens, self.embed_text(context))

    def forward(self, img, text=None, mask_ratio=0.75, generator=None):
        """The training loss of a batch (reference generate.py:136-146)."""
        img = vm._as_nhwc(img, self.device)
        return pipeline_loss(self, img, self.embed_text(text), mask_ratio,
                             generator=generator or self._generator)

    def ids2tokens(self, ids):
        return ids_to_tokens(self, torch.as_tensor(ids, device=self.device),
                             self.config)

    # -- sampling --------------------------------------------------------

    @torch.no_grad()
    def sample(self, ids, mask_ratio, text=None, topk=1, temperature=1.0,
               generator=None, guidance_scale=None):
        """One decode step (reference generate.py:159-181); returns
        (ids_next, img)."""
        context = self.embed_text(text)
        n_masked = max(int(mask_ratio * self.num_tokens), 1)
        ids_next, pred = sample_step(
            self, torch.as_tensor(ids, device=self.device), context=context,
            n_masked=n_masked, temperature=temperature, topk=topk,
            cfg=self.config, guidance_scale=guidance_scale,
            dtype=self.compute_dtype, generator=generator or self._generator)
        return ids_next, self.vqgan.decode_from_indice(pred)

    @torch.no_grad()
    def generate(self, text=None, timesteps=18, temperature=1.0, topk=5,
                 save_interval=2, generator=None, guidance_scale=None,
                 num_samples=None, decode_steps='saved', cfg_warmup=0.0,
                 negative_text=None, trajectory='merged'):
        """(reference generate.py:183-198).  Returns a list of (B, H, W, 3)
        image batches: one per saved step ('saved') or just the final one
        ('final').  ``negative_text``: context(s) the guidance pushes away
        from, in place of the unconditional branch."""
        if negative_text is not None:
            if guidance_scale is None:
                raise ValueError('negative_text requires guidance_scale — '
                                 'without it the negative prompt would be '
                                 'silently ignored')
            if text is None:
                raise ValueError('negative_text requires a (positive) text '
                                 'condition to guide towards')
        context = self.embed_text(text)
        neg_context = self.embed_text(negative_text)
        if neg_context is not None and neg_context.shape[0] == 1:
            neg_context = neg_context.expand(context.shape)
        b = context.shape[0] if context is not None else (num_samples or 1)
        init_ids = torch.full((b, self.num_tokens), self.mask_token_id,
                              dtype=torch.int32, device=self.device)
        _, shown = generate_ids(
            self, init_ids, context, cfg=self.config, timesteps=timesteps,
            temperature=temperature, topk=topk, guidance_scale=guidance_scale,
            dtype=self.compute_dtype, cfg_warmup=cfg_warmup,
            neg_context=neg_context, trajectory=trajectory,
            generator=generator or self._generator)
        if decode_steps == 'final':
            steps = [timesteps - 1]
        else:  # every save_interval-th step (generate.py:195-196)
            steps = list(range(0, timesteps, save_interval))
        sel = shown[steps]  # (S, B, L)
        s = len(steps)
        if s * b <= 128:
            imgs = self.vqgan.decode_from_indice(sel.reshape(s * b, -1))
            imgs = imgs.reshape(s, b, *imgs.shape[1:])
            return [imgs[i] for i in range(s)]
        return [self.vqgan.decode_from_indice(sel[i]) for i in range(s)]

    def _rect_latent_mask(self, coord, inside):
        """(reference generate.py:204-210): latent-grid mask from the pixel
        rect coord = (x, y, h, w), ``inside`` = value inside the rect; a
        sequence of per-sample rects gives a (B, L) mask."""
        s = self.patch_size
        g = self.image_size // s
        coords = ([coord] if not coord or np.isscalar(coord[0])
                  else list(coord))
        rows = []
        for c in coords:
            x, y, h, w = (int(v) // s for v in c)
            keep = np.full((g, g), 1 - inside, dtype=np.int32)
            keep[y:y + h, x:x + w] = inside
            rows.append(keep.reshape(-1))
        return torch.as_tensor(np.stack(rows), device=self.device)

    @torch.no_grad()
    def paint(self, img, keep_mask, text=None, timesteps=1, topk=1,
              temperature=0.0, generator=None, guidance_scale=None):
        """Paint with a per-sample latent keep-mask (B, L) or (1, L):
        1 = keep the original token, 0 = regenerate.  ``temperature`` may be
        per-sample (B,)."""
        _, ids, context = self.to_latent(img, text)
        keep = torch.as_tensor(keep_mask, device=self.device).bool()
        ids = torch.where(keep, ids, torch.full((), self.mask_token_id,
                                                dtype=ids.dtype,
                                                device=ids.device))
        _, merged = generate_ids(
            self, ids, context, cfg=self.config, timesteps=timesteps,
            temperature=temperature, topk=topk, guidance_scale=guidance_scale,
            dtype=self.compute_dtype, clamp_remask=True,
            generator=generator or self._generator)
        return self.vqgan.decode_from_indice(merged[-1])

    def inpaint(self, img, coord, text=None, timesteps=1, topk=1,
                temperature=0.0, generator=None, guidance_scale=None):
        """Regenerate inside the rect (reference generate.py:200-217)."""
        keep = self._rect_latent_mask(coord, inside=0)
        return self.paint(img, keep, text, timesteps, topk, temperature,
                          generator, guidance_scale)

    def outpaint(self, img, coord, text=None, timesteps=1, topk=1,
                 temperature=0.0, generator=None, guidance_scale=None):
        """Regenerate outside the rect (reference generate.py:219-236)."""
        keep = self._rect_latent_mask(coord, inside=1)
        return self.paint(img, keep, text, timesteps, topk, temperature,
                          generator, guidance_scale)

    # -- not in this slice ----------------------------------------------

    def quantize(self, mode='w8a8', **kw):
        raise _not_ported('int8 quantization', 9)

    def enable_pipeline_parallel(self, *a, **kw):
        raise _not_ported('pipeline-parallel decode', 10)

    # -- checkpointing ---------------------------------------------------

    def from_pretrained(self, path):
        """Weights from the JAX package's ``.npz`` or a reference ``.pt`` /
        ``.pth`` / ``.bin`` state dict (``utils.checkpoint.load_flat``)."""
        from ..convert.from_jax import load_jax_params
        from ..utils.checkpoint import load_flat
        load_jax_params(self, load_flat(path, 'pipeline'))
        return self

    def save_pretrained(self, path):
        """Write every parameter as a ``.npz`` in the JAX package's layout,
        which ``paintmind_tpu``'s ``Pipeline.from_pretrained`` reads."""
        from ..convert.from_jax import to_flat
        from ..utils.checkpoint import save_params
        return save_params(path, to_flat(self))

    @property
    def num_params(self):
        return sum(p.numel() for p in self.parameters())
