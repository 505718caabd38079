"""The comparison that decides ``correct``.

Text-to-image generation (``judge_generate``).  The window keeps, for every
call, the input tokens of each sampler step and the codes the VQGAN
decodes, beside the images the call returned.  The reference
(``reference/model.py``) takes the benchmark's own weights and contexts
and reads the program's outputs only to judge them:

* ``struct_errors`` (every call, every step): a step's tokens that are no
  row of the sampling table; a first step that is not all masked; a
  committed token that changes later; a step that leaves another number of
  masked positions than the cosine schedule; final codes that are no
  l2-normalised codebook row or leave a position masked.  Exact: limit 0.
* ``token_gap_max`` (one call drawn from the seed, ``check_steps`` of its
  steps drawn from the seed, the last always among them): the reference
  computes the guided logits of the step from the program's input ids and
  the contexts; every token the step committed must lie in the reference's
  top-k.  The number is the widest gap by which a committed token's
  reference logit lies below the reference's k-th best (0 inside the kept
  set), in logit units.  A sampled token is judged by its kept set, as a
  greedy one by the best alone.
* ``token_miss_share`` (the same tokens): the share of them that lie
  outside the reference's top-k.  A cell compares the numbers its
  ``limits`` name: a cell whose sound runs draw a rare token just outside
  the reference's kept set by a sizeable gap (a routed model whose
  balanced router flips a token's experts under bf16 rounding) compares
  this share in place of the widest gap.
* ``sample_kl`` (rows of that call drawn from the seed, at its judged
  steps): the mean over positions of KL(softmax(ref) || softmax(prog)),
  between the guided logits the program's vocabulary head produced and the
  reference's: how far the distribution the sampler draws from lies from
  the reference's.  (The relative RMS logit error is a diagnostic.)
* ``image_err_max``: the largest absolute difference between the call's
  images and the reference's decode of its final codes, in [-1, 1] units.

The call, its steps and the rows are drawn from the seed before the
window (``sample``), so that the generator keeps the logits of those alone;
the window runs at least until that call is done.

Controls (``control.py``): with ``control='program'`` the program runs
its int8 path (``Pipeline.quantize('w8a8')``), and its readings are the
numbers themselves.  With any control the reference, computed in fp8 (``CONTROL``),
also stands in the program's place at the same inputs: it gives its own
logits, draws each judged position's token from its own top-k with Gumbel
noise at the step's temperature, and decodes the final codes; those
readings are reported as ``<number>.control``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import model as ref

CONTROL = 'fp8'   # the reference's precision when it stands in as the control


def sample(run, timesteps, batch, rows=8, calls=3):
    """The call, steps and rows the check judges, drawn from the seed."""
    rng = np.random.default_rng(run.rng_seed('check'))
    n = min(int(run.cell.check['check_steps']), timesteps)
    steps = sorted(rng.choice(timesteps - 1, n - 1, replace=False).tolist())
    picked = np.sort(rng.choice(batch, min(rows, batch), replace=False))
    return {'call': int(rng.integers(calls)), 'steps': steps + [timesteps - 1],
            'rows': torch.as_tensor(picked, device=run.device)}


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


def _kl(want, got):
    """Mean over positions of KL(softmax(want) || softmax(got)): how far
    the distribution the sampler draws from lies from the reference's."""
    lp = torch.log_softmax(want, dim=-1)
    lq = torch.log_softmax(got.float(), dim=-1)
    return float((lp.exp() * (lp - lq)).sum(-1).mean())


def _step_numbers(W, pipe_cfg, tr, ids, nxt, context, t, T, control, gen,
                  kept, rows):
    """The gaps of the tokens committed at step ``t``; the relative error
    and the KL of the program's kept logits (``kept``: the drawn ``rows``
    of one pass, or of the two passes that guidance mixes); with a control,
    the reduced-precision reference's readings at the same inputs."""
    table = ref.sampling_table(W)
    mask_id = table.shape[0] - 1
    tokens = table[ids]
    scale = tr['guidance_scale']
    logits = ref.guided_logits(W, pipe_cfg, tokens, context, scale)
    k = tr['topk']
    kth = torch.topk(logits, k, dim=-1).values[..., -1]
    pos = (ids == mask_id) & (nxt != mask_id)
    chosen = nxt.clamp(max=mask_id - 1).long()
    got = logits.gather(-1, chosen[..., None])[..., 0]
    gaps = (kth - got)[pos].clamp_min(0)
    err = (float('nan'), float('nan'))
    if kept and all(x is not None for x in kept):
        prog = kept[0].float()
        if len(kept) == 2:          # the two passes; guidance mixes logits
            prog = kept[1].float() + scale * (prog - kept[1].float())
        err = (_rel(prog, logits[rows]), _kl(logits[rows], prog))
    ctl = None
    if control is not None:
        low = ref.guided_logits(W, pipe_cfg, tokens, context, scale,
                                lowp=CONTROL)
        kth_low = torch.topk(low, k, dim=-1).values[..., -1:]
        temp = max(tr['temperature'] * (1.0 - t / T), 1e-10)
        u = torch.rand(low.shape, generator=gen, device=low.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0)).clamp_min(1e-20))
        filt = torch.where(low >= kth_low, low / temp + gumbel,
                           torch.full((), -float('inf'), device=low.device))
        pick = filt.argmax(-1)
        ctl = ((kth - logits.gather(-1, pick[..., None])[..., 0])[pos]
               .clamp_min(0), (_rel(low[rows], logits[rows]),
                               _kl(logits[rows], low[rows])))
    return gaps, err, ctl


def judge_generate(s, spec):
    """``[(name, value, limit)]`` for a batch-generation run ``s``."""
    device = s.run.device
    if device != 'cpu':
        ref.fp32_mode()
    W = s.weights.to(device).tensors()
    pipe_cfg, s1, tr = s.cfg['pipeline'], s.cfg['stage1'], s.tr
    T = tr['timesteps']
    table = ref.sampling_table(W)
    mask_id = table.shape[0] - 1
    codes = ref.l2norm(W['vqgan.quantize.codebook'])
    counts = ref.mask_counts(
        (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2, T)
    struct = 0
    calls = []
    b = tr['batch']
    for out in s.out:
        steps = []
        for tok in out['steps']:
            if tok.shape[0] == 2 * b:   # one pass over [cond; uncond] rows
                struct += int((tok[:b] != tok[b:]).any())
                tok = tok[:b]
            ids, dist = ref.ids_of_rows(tok, table)
            struct += int((dist > 1e-2).sum())
            steps.append(ids)
        final, dist = ref.ids_of_rows(out['codes'][-1], codes)
        struct += int((dist > 1e-2).sum())
        if len(steps) != T or not bool((steps[0] == mask_id).all()):
            struct += 1
            calls.append(None)
            continue
        for t in range(T):
            cur = steps[t]
            nxt = steps[t + 1] if t + 1 < T else final
            held = cur != mask_id
            struct += int((held & (nxt != cur)).any(dim=1).sum())
            left = (nxt == mask_id).sum(dim=1)
            want = counts[t] if t + 1 < T else 0
            struct += int((left != want).sum())
        calls.append((steps, final))
    numbers = [('struct_errors', float(struct))]

    c, chosen, rows = s.sample['call'], s.sample['steps'], s.sample['rows']
    gaps, errs, ctl, ctl_err = [], [], [], []
    img_err = ctl_img = float('nan')
    if c < len(calls) and calls[c] is not None:
        steps, final = calls[c]
        context = s.contexts[s.out[c]['ctx']]
        gen = torch.Generator(device=device).manual_seed(
            s.run.rng_seed('control'))
        for t in chosen:
            nxt = steps[t + 1] if t + 1 < T else final
            g, e, gc = _step_numbers(W, pipe_cfg, tr, steps[t], nxt, context,
                                     t, T, s.run.control, gen,
                                     (s.out[c]['logits'] or {}).get(t), rows)
            gaps.append(g)
            errs.append(e)
            if gc is not None:
                ctl.append(gc[0])
                ctl_err.append(gc[1])
        want = ref.decode(W, s1, final)
        img_err = float((s.out[c]['images'].float() - want).abs().max())
        if s.run.control is not None:
            low = ref.decode(W, s1, final, lowp=CONTROL)
            ctl_img = float((low - want).abs().max())
    gaps = torch.cat(gaps) if gaps else torch.full((1,), float('nan'))
    kl = float(np.mean([e[1] for e in errs])) if errs else float('nan')
    miss = float('nan') if bool(gaps.isnan().any()) else float(
        (gaps > 0).float().mean())
    numbers += [('token_gap_max', float(gaps.max())),
                ('token_miss_share', miss), ('sample_kl', kl),
                ('image_err_max', img_err)]
    if ctl:
        ctl_gaps = torch.cat(ctl)
        numbers += [('token_gap_max.control', float(ctl_gaps.max())),
                    ('token_miss_share.control',
                     float((ctl_gaps > 0).float().mean())),
                    ('sample_kl.control', float(np.mean([e[1] for e in ctl_err]))),
                    ('image_err_max.control', ctl_img)]
    limits = spec['limits']
    s.diagnostics = {
        'judged_tokens': int(gaps.numel()),
        'logit_err': max(e[0] for e in errs) if errs else None,
        'checked_call': c,
        'checked_steps': chosen}
    s.diagnostics.update((n, v) for n, v in numbers
                         if n.split('.')[0] not in limits)
    if ctl:
        s.diagnostics['logit_err.control'] = max(e[0] for e in ctl_err)
    return [(n, v, limits[n.split('.')[0]]) for n, v in numbers
            if n.split('.')[0] in limits]


def _png_levels(b64):
    import base64
    import io

    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert('RGB')
    return torch.as_tensor(np.asarray(img).astype(np.int16))


def _levels(img):
    """The server's conversion of an image in [-1, 1] to 8-bit levels."""
    x = ((img.float() + 1.0) * 127.5).clamp(0, 255)
    return x.cpu().numpy().astype(np.uint8).astype(np.int16)


def judge_serving(s, stats, spec):
    """``[(name, value, limit)]`` for a serving run ``s``: every request due
    in the window must have got its image (``lost``: no answer within the
    grace past the window, or an error status); every engine batch
    passes the structural checks of ``judge_generate``; a sample of the
    answered requests drawn from the seed (``check_requests``, both kinds
    among them) is judged end to end:

    * ``context_err``: the relative difference between the tower's output
      for the request's prompt and the reference T5's (``reference/t5.py``)
      on the stand-in tokenizer's ids;
    * ``token_gap_max``: as in ``judge_generate``, at ``check_steps`` steps
      of the request's row of its batch, on the reference's own context;
    * ``png_err_max``: the largest difference, in 8-bit levels, between
      the PNG the client received and the reference's decode of the row's
      final codes, converted as the server converts.
    """
    from reference import t5 as rt5
    from tokenizer import hash_tokenizer
    device = s.run.device
    if device != 'cpu':
        ref.fp32_mode()
    W = s.weights.to(device).tensors()
    TW = s.tower_weights.to(device).tensors()
    pipe_cfg, s1, tr, tcfg = (s.cfg['pipeline'], s.cfg['stage1'], s.tr,
                              s.cfg['tower'])
    T = tr['timesteps']
    table = ref.sampling_table(W)
    mask_id = table.shape[0] - 1
    codes = ref.l2norm(W['vqgan.quantize.codebook'])
    counts = ref.mask_counts(
        (s1['enc']['image_size'] // s1['enc']['patch_size']) ** 2, T)
    recs = stats['requests']
    lost = sum(1 for r in recs if r['status'] != 200)
    struct = 0
    batches = []
    for bt in s.batches:
        b = bt['context'].shape[0] if bt['context'] is not None else None
        steps = []
        for tok in bt['steps']:
            if b is not None and tok.shape[0] == 2 * b:
                struct += int((tok[:b] != tok[b:]).any())
                tok = tok[:b]
            ids, dist = ref.ids_of_rows(tok, table)
            struct += int((dist > 1e-2).sum())
            steps.append(ids)
        if len(steps) != T or not bt['codes']:
            struct += 1
            batches.append(None)
            continue
        final, dist = ref.ids_of_rows(bt['codes'][-1], codes)
        struct += int((dist > 1e-2).sum())
        struct += int((steps[0] != mask_id).any())
        for t in range(T):
            nxt = steps[t + 1] if t + 1 < T else final
            held = steps[t] != mask_id
            struct += int((held & (nxt != steps[t])).any(dim=1).sum())
            want = counts[t] if t + 1 < T else 0
            struct += int(((nxt == mask_id).sum(dim=1) != want).sum())
        batches.append((steps, final))

    rng = np.random.default_rng(s.run.rng_seed('check'))
    ok = [r for r in recs if r['status'] == 200]
    by_k = {}
    for r in ok:
        by_k.setdefault(r['body']['topk'], []).append(r)
    picked = []
    n = int(spec['check_requests'])
    for k in sorted(by_k):          # one of each kind first
        picked.append(by_k[k][int(rng.integers(len(by_k[k])))])
    rest = [r for r in ok if r not in picked]
    for i in rng.permutation(len(rest))[:max(0, n - len(picked))]:
        picked.append(rest[int(i)])
    enc_ids = [(a.reshape(-1), out) for a, out in s.encodes]
    ctx_err, gaps, png_err = [], [], []
    ctl_ctx, ctl_gaps, ctl_png = [], [], []
    unmatched = 0
    gen = torch.Generator(device=device).manual_seed(s.run.rng_seed('control'))
    for r in picked:
        ids = torch.as_tensor(hash_tokenizer([r['body']['prompt']], max_length=
                              tcfg['max_length'])['input_ids'], device=device)
        want_ctx = rt5.encode(TW, tcfg, ids)
        prog_ctx = next((out for a, out in enc_ids
                         if a.numel() == ids.numel() and torch.equal(a, ids[0])),
                        None)
        where = None
        if prog_ctx is not None:
            row = prog_ctx[0].to(torch.bfloat16)
            for j, bt in enumerate(s.batches):
                if bt['context'] is None or batches[j] is None:
                    continue
                hit = (bt['context'].to(torch.bfloat16) == row).all(-1).all(-1)
                if bool(hit.any()):
                    where = (j, int(hit.nonzero()[0, 0]))
                    break
        if where is None:
            unmatched += 1
            continue
        ctx_err.append(_rel(prog_ctx[0], want_ctx[0]))
        if s.run.control is not None:
            ctl_ctx.append(_rel(rt5.encode(TW, tcfg, ids, lowp='tf32')[0],
                                want_ctx[0]))
        steps, final = batches[where[0]]
        row = where[1]
        sub = dict(tr, topk=r['body']['topk'],
                   guidance_scale=r['body']['guidance_scale'],
                   temperature=r['body']['temperature'])
        chosen = sorted(rng.choice(T - 1, int(spec['check_steps']) - 1,
                                   replace=False).tolist()) + [T - 1]
        for t in chosen:
            nxt = steps[t + 1] if t + 1 < T else final
            g, _, gc = _step_numbers(W, pipe_cfg, sub, steps[t][row:row + 1],
                                     nxt[row:row + 1], want_ctx, t, T,
                                     s.run.control, gen, None, None)
            gaps.append(g)
            if gc is not None:
                ctl_gaps.append(gc[0])
        img = ref.decode(W, s1, final[row:row + 1])[0]
        got = _png_levels(r['image'])
        png_err.append(int(np.abs(got.numpy() - _levels(img)).max()))
        if s.run.control is not None:
            low = ref.decode(W, s1, final[row:row + 1], lowp=CONTROL)[0]
            ctl_png.append(int(np.abs(_levels(low) - _levels(img)).max()))
    gaps = torch.cat(gaps) if gaps else torch.full((1,), float('nan'))
    numbers = [('lost', float(lost)), ('struct_errors', float(struct + unmatched)),
               ('context_err', max(ctx_err) if ctx_err else float('nan')),
               ('token_gap_max', float(gaps.max())),
               ('png_err_max', float(max(png_err)) if png_err else float('nan'))]
    if ctl_gaps:
        numbers += [('context_err.control', max(ctl_ctx)),
                    ('token_gap_max.control', float(torch.cat(ctl_gaps).max())),
                    ('png_err_max.control', float(max(ctl_png)))]
    s.diagnostics = {'judged_requests': len(picked) - unmatched,
                     'judged_tokens': int(gaps.numel()), 'unmatched': unmatched,
                     'batches': len(s.batches),
                     'send_late_p95_s': stats['send_late_p95_s'],
                     'send_late_max_s': stats['send_late_max_s']}
    limits = spec['limits']
    return [(n, v, limits.get(n.split('.')[0])) for n, v in numbers]


def _worst_leaf(prog, want, leaves):
    """The largest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's."""
    ref_n = {n: float(want[n].norm()) for n in leaves}
    med = float(np.median(list(ref_n.values())))
    return max(abs((float(prog[n].norm()) if n in prog else 0.0) - ref_n[n])
               / max(ref_n[n], med) for n in leaves)


def _masked(tokens):
    """The masked positions of the tokens a training step's transformer
    received: the mask token's row (norm ~0.1 in these weights) where the
    others are l2-normalised code rows (norm 1)."""
    return tokens.float().norm(dim=-1) < 0.5


def _reference_updates(W, s, seen, lowp=None, rows=4):
    """The reference's own run of the followed updates from the benchmark's
    weights: (losses, first clipped gradients, parameters after)."""
    p2, rc = s.cfg['pipeline'], {**s.tr['trainer'], **s.tr['recipe']}
    trainable = [n for n in W if n == 'mask_token' or n.startswith('transformer.')]
    P = dict(W)
    for n in trainable:
        P[n] = W[n].float().clone().requires_grad_(True)
    moments = {n: torch.zeros_like(P[n]) for n in trainable}
    codes = ref.l2norm(W['vqgan.quantize.codebook'])
    device = W['mask_token'].device
    losses, first = [], None
    for t, step in enumerate(seen):
        ids = step['ids'].to(device).long()
        masked = _masked(step['tokens'].to(device))
        ctx = None
        if step['context'] is not None:
            ctx = s.contexts[step['idx'].to(device)].float()
        count = masked.float().sum()
        total = 0.0
        for i in range(0, ids.shape[0], rows):
            sl = slice(i, i + rows)
            tok = torch.where(masked[sl, :, None], P['mask_token'][None],
                              codes[ids[sl]])
            keeps = [k[sl].to(device) for k in step['keeps']]
            logits = ref.transformer(P, p2, tok, None if ctx is None
                                     else ctx[sl], lowp, keeps=keeps)
            loss = ref.masked_ce(logits, ids[sl], masked[sl].float(),
                                 rc['label_smoothing']) / count
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {n: P[n].grad for n in trainable}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        coef = min(1.0, rc['max_grad_norm'] / (float(norm) + 1e-6))
        grads = {n: g * coef for n, g in grads.items()}
        if t == 0:
            first = {n: g.detach().clone() for n, g in grads.items()}
        lr = ref.warmup_cosine(t, rc['lr'], rc['lr_min'], rc['warmup_steps'],
                               rc['warmup_lr_init'], rc['decay_steps'])
        ref.lion_update({n: P[n] for n in trainable}, grads, moments, lr,
                        tuple(rc['lion_betas']), rc['weight_decay'])
        for n in trainable:
            P[n].grad = None
    return losses, first, {n: P[n].detach() for n in trainable}


def judge_train(s, spec):
    """``[(name, value, limit)]`` for a training run ``s``.  The reference
    runs the updates the set-up followed from the benchmark's weights, in
    fp32, at the program's batch.  It follows the program's own state where
    that state is drawn at random inside the program: the masked positions
    (from the masked tokens the transformer received), the dropout
    keep-masks (the zeros of each attention output), whether the text was
    dropped, and the codes the frozen VQGAN chose as labels; it checks that
    stage by itself:

    * ``batch_errors``: followed updates whose encode did not receive the
      batch the loader fed the call (every row, in the compute type);
    * ``encode_mismatch``: the share of positions whose code (kernel K2 on
      the program's encode) differs from the reference encoder's, the
      largest over the followed updates;
    * ``mask_errors``: updates whose rows mask different numbers of
      positions, or none, or whose masked positions hold different rows;
    * ``loss_gap``: the largest relative gap between an update's loss and
      the reference's;
    * ``grad_gap``: the first update's clipped gradient as the optimizer
      got it (Lion's moment after one update over ``1 - beta2``) against
      the reference's, by the worst leaf;
    * ``delta_gap``: the parameters' change over the followed updates, by
      the worst leaf, leaving out leaves whose reference gradient is under
      a thousandth of the median leaf's.
    """
    device = s.run.device
    if device != 'cpu':
        ref.fp32_mode()
    W = s.weights.to(device).tensors()
    seen = s.followed
    mismatch, mask_err, batch_err = 0.0, 0, 0
    for step in seen:
        fed = step['fed'].to(device).to(step['images'].dtype)
        got_img = step['images'].to(device)
        if fed.shape != got_img.shape or bool((fed != got_img).any()):
            batch_err += 1
            continue
        want = ref.encode_ids(W, s.cfg['stage1'], step['images'].to(device))
        got = step['ids'].to(device).long()
        mismatch = max(mismatch, float((want != got).float().mean()))
        tokens = step['tokens'].to(device)
        masked = _masked(tokens)
        counts = masked.sum(-1)
        rows = tokens[masked]
        mask_err += int(bool((counts != counts[0]).any()) or int(counts[0]) == 0
                        or bool((rows != rows[:1]).any()))
    if batch_err:
        nan = float('nan')
        return [(n, v, spec['limits'].get(n)) for n, v in (
            ('batch_errors', float(batch_err)), ('encode_mismatch', nan),
            ('mask_errors', nan), ('loss_gap', nan), ('grad_gap', nan),
            ('delta_gap', nan))]
    losses, first, after = _reference_updates(W, s, seen)
    b2 = s.tr['recipe']['lion_betas'][1]
    prog_g = {n: m.to(device) / (1.0 - b2) for n, m in seen[0]['moments'].items()}
    leaves = sorted(first)
    gnorm = {n: float(first[n].norm()) for n in leaves}
    med = float(np.median(list(gnorm.values())))
    moving = [n for n in leaves if gnorm[n] >= 1e-3 * med]
    prog_d = {n: seen[-1]['params'][n].to(device) - W[n].float() for n in moving}
    ref_d = {n: after[n] - W[n].float() for n in moving}
    prog_loss = [st['loss'] for st in seen]
    numbers = [
        ('batch_errors', 0.0),
        ('encode_mismatch', mismatch), ('mask_errors', float(mask_err)),
        ('loss_gap', max(abs(a - b) / abs(b) for a, b in zip(prog_loss, losses))),
        ('grad_gap', _worst_leaf(prog_g, first, leaves)),
        ('delta_gap', _worst_leaf(prog_d, ref_d, moving))]
    if s.run.control is not None:
        lo_losses, lo_first, lo_after = _reference_updates(W, s, seen,
                                                           lowp=CONTROL)
        lo_d = {n: lo_after[n] - W[n].float() for n in moving}
        numbers += [
            ('loss_gap.control', max(abs(a - b) / abs(b)
                                     for a, b in zip(lo_losses, losses))),
            ('grad_gap.control', _worst_leaf(lo_first, first, leaves)),
            ('delta_gap.control', _worst_leaf(lo_d, ref_d, moving))]
    s.diagnostics = {'losses': prog_loss, 'reference_losses': losses,
                     'leaves': len(leaves), 'moving_leaves': len(moving),
                     'text_dropped': [st['context'] is None for st in seen]}
    limits = spec['limits']
    return [(n, v, limits.get(n.split('.')[0])) for n, v in numbers]
