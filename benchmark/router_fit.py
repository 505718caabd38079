"""A router at a trained router's load (a configuration's ``router_init``).

A router trained with the load-balance loss keeps nearly all of its top-k
assignments at capacity factor 1.25.  A router drawn at random like every
other matrix keeps about half of them, and a program that runs only the
kept assignments then does half a deployment's expert work.  With
``"router_init": {"kind": "load_balanced", ...}`` ``weights.make``
replaces the seeded draw of each routed layer's ``router.weight``, layer 0
first, by a router that spreads every call's tokens evenly over the
experts, fitted on the plain reference (``reference/model.py``):

* inputs, drawn from a salt of the weights' seed: ``rows`` contexts drawn
  as the traffic draws its own (``context_len`` rows of the context width,
  normal times ``context_scale``, in the served type), and the token grids
  that the traffic's guided sampler (``timesteps`` steps, ``topk``,
  ``temperature``, ``guidance_scale``) reads at each of its steps, drawn by
  the reference from the weights; one step's rows of one pass (conditional
  or unconditional) are one routing call, whose token count sets the
  capacity;
* targets: each of the L positions gets a first and a second expert, every
  ordered pair of experts about equally often, and a token's target logits
  are those of probabilities 0.6 and 0.3 on its position's pair and the
  rest shared by the others; every call holds whole rows, so a router that
  meets its targets loads each expert alike in every call;
* each layer's router is the least-squares fit of those targets from the
  layer's inputs (``ridge`` times the inputs' mean second moment added to
  the normal matrix), computed in fp32; its inputs come through the
  routers already fitted.  The forward passes that make the inputs run
  with TF32 products.

The fitted weights, rounded to the served type, replace the draw in the
buffer that the program and the reference both take their weights from.
Nothing of the program runs.  The same seed gives the same bits on the
same device.
"""

from __future__ import annotations

import contextlib
import hashlib

import torch
import torch.nn.functional as F

from reference import model as ref


def _fit_seed(seed):
    h = hashlib.sha256(repr((int(seed), 'router_fit')).encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


@contextlib.contextmanager
def _precision(tf32):
    """fp32 products inside (TF32 where ``tf32``), the previous settings
    after."""
    prec = torch.get_float32_matmul_precision()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ref.fp32_mode()
    if tf32:
        torch.set_float32_matmul_precision('high')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def routed_ffn(W, p, x, cfg, lowp=None):
    """``reference.routed_ffn``'s output over ``x`` (B, N, D), one call,
    with no host synchronisation: the kept assignments are placed in an
    (E, C) slot buffer and the experts run over every slot (an empty slot
    is never read back).  Returns (output, None)."""
    e, k = cfg['num_experts'], min(cfg['num_selected'], cfg['num_experts'])
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    t, d = xt.shape
    probs = torch.softmax(xt @ W[p + 'router.weight'].float().t(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, :k], order.indices[:, :k]
    gate = (gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)).t().reshape(-1)
    cap = ref.capacity(t, k, e, cfg['capacity_factor'])
    flat = idx.t().reshape(-1)                                 # slot-major
    onehot = F.one_hot(flat, e)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = (pos < cap) & (gate > 0)
    slot = torch.where(keep, flat * cap + pos, e * cap)
    src = torch.zeros(e * cap + 1, dtype=torch.long, device=x.device)
    src[slot] = torch.arange(t, device=x.device).repeat(k)
    w12 = W[p + 'experts.w12.weight'].float().transpose(1, 2)
    w3 = W[p + 'experts.w3.weight'].float().transpose(1, 2)
    h = torch.baddbmm(W[p + 'experts.w12.bias'].float()[:, None],
                      xt[src[:-1]].view(e, cap, d), w12)
    a, b = h.chunk(2, dim=-1)
    out = torch.baddbmm(W[p + 'experts.w3.bias'].float()[:, None],
                        F.silu(a) * b, w3).reshape(e * cap, d)
    y = torch.where(keep[:, None], out[slot.clamp(max=e * cap - 1)]
                    * gate[:, None], 0.0)
    return y.reshape(k, t, d).sum(0).reshape(shape), None


def _contexts(config, p, g, device, dtype):
    """A context for each fitted row, drawn as the traffic draws its own."""
    return torch.randn((p['rows'], p['context_len'], config['t5_dim']),
                       generator=g, device=device, dtype=dtype) \
        * p['context_scale']


def _gumbel(shape, g, device):
    u = torch.rand(shape, generator=g, device=device)
    return -torch.log(-torch.log(u.clamp(1e-20, 1.0)).clamp_min(1e-20))


def sample_grids(W, config, p, ctx, g):
    """The input ids (steps, rows, L) of each step of the traffic's guided
    sampler, run by the reference on the rows of ``ctx``: top-k Gumbel
    draws at the step's temperature, the least confident drawn positions
    masked again as the cosine schedule says."""
    cfg, s1 = config['pipeline'], config['stage1']
    n = (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2
    steps = p['timesteps']
    table = ref.sampling_table(W)
    mask_id = table.shape[0] - 1
    counts = ref.mask_counts(n, steps)
    ids = torch.full((ctx.shape[0], n), mask_id, device=ctx.device)
    grids = []
    for t in range(steps):
        grids.append(ids)
        if t + 1 == steps:
            break
        logits = ref.guided_logits(W, cfg, table[ids], ctx,
                                   p['guidance_scale'], routed=routed_ffn)
        kth = torch.topk(logits, p['topk'], dim=-1).values[..., -1:]
        temp = max(p['temperature'] * (1.0 - t / steps), 1e-10)
        noisy = logits / temp + _gumbel(logits.shape, g, logits.device)
        pred = torch.where(logits >= kth, noisy, -float('inf')).argmax(-1)
        conf = torch.softmax(logits, dim=-1).gather(-1, pred[..., None])[..., 0]
        masked = ids == mask_id
        score = torch.where(masked, 1.0 - conf, -1e5)
        rank = torch.sort(score, dim=-1, descending=True,
                          stable=True).indices.argsort(-1)
        ids = torch.where(rank < counts[t], mask_id,
                          torch.where(masked, pred, ids))
    return torch.stack(grids)


def position_targets(n, e, g, device):
    """Target logits (n, E): each position a first and a second expert,
    every ordered pair of experts about equally often, in random order."""
    pairs = torch.tensor([(a, b) for a in range(e) for b in range(e)
                          if a != b], device=device)
    pairs = pairs.repeat(-(-n // len(pairs)), 1)[:n]
    pairs = pairs[torch.randperm(n, generator=g, device=device)]
    probs = torch.full((n, e), 0.1 / (e - 2), device=device)
    probs.scatter_(1, pairs[:, :1], 0.6)
    probs.scatter_(1, pairs[:, 1:], 0.3)
    logits = probs.log()
    return logits - logits.mean(-1, keepdim=True)


def kept_share(h, w, cfg):
    """The share of the top-k assignments of the calls ``h`` (calls,
    tokens, D) that the router ``w`` (E, D) keeps: slot-major queues, each
    expert ``capacity`` slots over its call's tokens."""
    e, k = cfg['num_experts'], min(cfg['num_selected'], cfg['num_experts'])
    calls, n = h.shape[:2]
    top = torch.topk(torch.softmax(h @ w.float().t(), dim=-1), k, dim=-1)
    # the queue scanned along the inner axis (a scan down an outer axis of
    # E is slow on the card)
    queue = F.one_hot(top.indices, e).permute(0, 3, 2, 1).reshape(
        calls, e, k * n)
    pos = ((queue.cumsum(-1) - queue) * queue).sum(1)
    cap = ref.capacity(n, k, e, cfg['capacity_factor'])
    keep = (pos < cap) & (top.values.transpose(1, 2).reshape(calls, -1) > 0)
    return float(keep.float().mean())


def _fit_layer(h, targets, w0, cfg, p):
    """The least-squares router of ``targets`` (calls, tokens, E) from
    ``h`` (calls, tokens, D), in ``w0``'s type, and the kept shares of the
    draw ``w0`` and of the fit."""
    flat = h.reshape(-1, h.shape[-1])
    second = flat.t() @ flat / flat.shape[0]
    eye = torch.eye(second.shape[0], device=h.device)
    chol = torch.linalg.cholesky(
        second + p['ridge'] * second.diagonal().mean() * eye)
    moment = targets.reshape(-1, targets.shape[-1]).t() @ flat / flat.shape[0]
    w = torch.cholesky_solve(moment.t(), chol).t().to(w0.dtype)
    return w, {'kept_before': kept_share(h, w0, cfg),
               'kept_after': kept_share(h, w, cfg)}


def fit_layers(W, config, p, grids, ctx, targets):
    """Fit each routed layer's router of ``W`` in place, layer 0 first, on
    the token grids ``grids`` (steps, rows, L) with the rows' contexts
    ``ctx`` and a target a position ``targets`` (L, E); returns one report
    a layer."""
    cfg = config['pipeline']
    steps, rows, n = grids.shape
    table = ref.sampling_table(W)
    x, ctx = ref.embed(W, table[grids.reshape(steps * rows, n)],
                       ctx.repeat(steps, 1, 1))
    passes = [(x, ctx), (x, None)]           # conditional, unconditional
    targets = targets.repeat(2 * steps, rows, 1)
    report = []
    for i in range(cfg['depth']):
        q = f'transformer.layers.{i}.ffnet.'
        norm = f'transformer.layers.{i}.norm3.'
        passes = [(ref.attend(W, cfg, i, xp, cp), cp) for xp, cp in passes]
        hs = [ref.layer_norm(xp, W[norm + 'weight'], W[norm + 'bias'])
              for xp, _ in passes]
        d = hs[0].shape[-1]
        calls = torch.stack(hs).reshape(2 * steps, rows * n, d)
        with _precision(tf32=False):
            w, rep = _fit_layer(calls, targets, W[q + 'router.weight'], cfg,
                                p)
        W[q + 'router.weight'].copy_(w)
        report.append(rep)
        if i + 1 == cfg['depth']:
            break
        passes = [(xp + torch.cat([
            routed_ffn(W, q, hc, cfg)[0]
            for hc in hp.reshape(steps, rows, n, d)]).reshape(xp.shape), cp)
            for (xp, cp), hp in zip(passes, hs)]
    return report


def fit(weights, config, seed):
    """Fit every routed layer's router of ``weights`` (a ``Weights``) in
    place, as ``config['router_init']`` says; returns one report a
    layer."""
    p = config['router_init']
    if p.get('kind') != 'load_balanced':
        raise ValueError(f'unknown router_init kind {p.get("kind")!r}')
    W = weights.tensors()
    device, dtype = weights.flat.device, weights.flat.dtype
    g = torch.Generator(device=device).manual_seed(_fit_seed(seed))
    with torch.no_grad(), _precision(tf32=True):
        ctx = _contexts(config, p, g, device, dtype)
        grids = sample_grids(W, config, p, ctx, g)
        targets = position_targets(grids.shape[-1],
                                   config['pipeline']['num_experts'], g,
                                   device)
        return fit_layers(W, config, p, grids, ctx, targets)
