"""The comparison that decides ``correct`` for block-diffusion generation
(``generators/block_generate.py``), against the plain reference
``reference/sdar.py`` in fp32 on the benchmark's own weights and contexts,
reading the program's outputs only to judge them:

* ``struct_errors`` (every call, every pass): a pass's tokens that are no
  row of the sampling table; a block whose first step is not all masked; a
  step that leaves another number masked than the static schedule
  (``block_len - (s + 1)·block_len / steps`` after step s) or changes a
  token an earlier step unmasked; a commit pass that holds a mask; final
  codes that are no l2-normalised codebook row, or that differ in a block
  from what its commit pass wrote (the blocks finished before stay as they
  are); another number of passes than blocks × (steps + 1).  Exact:
  limit 0.
* ``logit_gap`` (the call drawn from the seed, ``check_pairs`` (block,
  step) pairs drawn from it, the last block's last step always among them,
  ``check_rows`` rows): the reference runs the whole sequence [prompt;
  finished blocks; the block's tokens at that step] under the block-causal
  mask, and the number is the largest relative RMS difference
  ‖prog − ref‖ / ‖ref‖ of a pair's logits.
* ``sample_kl`` (the same logits): the mean over positions of
  KL(softmax(ref) || softmax(prog)).
* ``token_miss_share`` (the tokens the drawn steps unmasked in the drawn
  rows): the share that lie outside the reference's top-k.
* ``cache_err`` (``check_layers`` layers drawn from the seed, the last
  always among them): the largest relative RMS difference between the KV
  cache the call left (the drawn rows, K and V apart) and the reference's
  K/V of the call's final sequence.
* ``image_err_max``: the largest absolute difference between the drawn
  rows' images and the reference's decode of their final codes, in [-1, 1]
  units.

With a control (``control.py``) the reference computed in fp8 (``CONTROL``)
stands in the program's place at the same inputs: its own logits, its own
picks at the judged positions (Gumbel top-k at the traffic's temperature),
its own K/V and decode, reported as ``<number>.control``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import model as ref
from reference import sdar

CONTROL = 'fp8'   # the reference's precision when it stands in as the control


def sample(run, blocks, steps, batch, depth, rows=None, calls=3):
    """The call, (block, step) pairs, rows and cache layers the check
    judges, drawn from the seed."""
    spec = run.cell.check
    rng = np.random.default_rng(run.rng_seed('check'))
    n = min(int(spec['check_pairs']), blocks * steps)
    flat = rng.choice(blocks * steps - 1, n - 1, replace=False)
    pairs = {divmod(int(i), steps) for i in flat} | {(blocks - 1, steps - 1)}
    rows = min(int(spec['check_rows']), batch)
    picked = np.sort(rng.choice(batch, rows, replace=False))
    layers = sorted({int(i) for i in rng.choice(
        depth - 1, min(int(spec['check_layers']), depth) - 1,
        replace=False)} | {depth - 1})
    return {'call': int(rng.integers(calls)), 'pairs': pairs,
            'rows': torch.as_tensor(picked, device=run.device),
            'layers': layers}


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


def _kl(want, got):
    lp = torch.log_softmax(want, dim=-1)
    lq = torch.log_softmax(got.float(), dim=-1)
    return float((lp.exp() * (lp - lq)).sum(-1).mean())


def _structure(out, table, codes, p, mask_id):
    """struct_errors of one call, and its ids: (errors, passes' ids,
    final ids)."""
    n, steps = p['block_len'], p['block_steps']
    per = n // steps
    errors = 0
    ids = []
    for tok in out['passes']:
        i, dist = ref.ids_of_rows(tok, table)
        errors += int((dist > 1e-2).sum())
        ids.append(i)
    final, dist = ref.ids_of_rows(out['codes'][-1], codes)
    errors += int((dist > 1e-2).sum())
    blocks = final.shape[1] // n
    if len(ids) != blocks * (steps + 1):
        return errors + 1, ids, final
    for j in range(blocks):
        seq = ids[j * (steps + 1):(j + 1) * (steps + 1)]
        errors += int((seq[0] != mask_id).any(dim=1).sum())
        for s in range(steps):
            cur, nxt = seq[s], seq[s + 1]
            held = cur != mask_id
            errors += int((held & (nxt != cur)).any(dim=1).sum())
            left = (nxt == mask_id).sum(dim=1)
            errors += int((left != n - per * (s + 1)).sum())
        errors += int((final[:, j * n:(j + 1) * n] != seq[steps])
                      .any(dim=1).sum())
    return errors, ids, final


def _judged(W, cfg, tr, context, seqs, lowp, layers, gen, picks):
    """The reference at ``lowp`` on the drawn sequences: (logits per pair,
    K/V of the final sequence at ``layers``, and, with ``picks``, its own
    draw at each pair's unmasked positions)."""
    logits, kv = sdar.forward(W, cfg, context, seqs, cfg['block_len'], lowp,
                              kv_layers=layers)
    out = []
    for lg in logits[:-1]:
        pick = None
        if picks:
            kth = torch.topk(lg, tr['topk'], dim=-1).values[..., -1:]
            u = torch.rand(lg.shape, generator=gen, device=lg.device)
            gum = -torch.log(-torch.log(u.clamp(1e-20, 1.0)).clamp_min(1e-20))
            temp = max(float(tr['temperature']), 1e-10)
            pick = torch.where(lg >= kth, lg / temp + gum,
                               torch.full((), -float('inf'),
                                          device=lg.device)).argmax(-1)
        out.append((lg, pick))
    return out, {i: kv[i][-1] for i in layers}


def judge(s, spec):
    """``[(name, value, limit)]`` for a block-generation run ``s``."""
    device = s.run.device
    if device != 'cpu':
        ref.fp32_mode()
    cfg = s.cfg
    p = dict(cfg['pipeline'])
    s1, tr = cfg['stage1'], s.tr
    W = s.reference_weights()
    table = ref.sampling_table(W)
    mask_id = table.shape[0] - 1
    codes = ref.l2norm(W['vqgan.quantize.codebook'])
    struct = 0
    calls = []
    for out in s.out:
        e, ids, final = _structure(out, table, codes, p, mask_id)
        struct += e
        calls.append((ids, final))
    numbers = [('struct_errors', float(struct))]

    c, rows = s.sample['call'], s.sample['rows']
    steps, n = p['block_steps'], p['block_len']
    pairs = sorted(s.sample['pairs'])
    layers = s.sample['layers']
    nan = float('nan')
    got = {k: nan for k in ('logit_gap', 'token_miss_share', 'sample_kl',
                            'cache_err', 'image_err_max')}
    ctl = {}
    if c < len(s.out) and len(calls[c][0]) == len(s.out[c]['passes']):
        out = s.out[c]
        ids, final = calls[c]
        toks = [t[rows].float() for t in out['passes']]
        commit = [toks[j * (steps + 1) + steps] for j in range(len(toks) // (steps + 1))]
        seqs = [torch.cat(commit[:j] + [toks[j * (steps + 1) + st]], dim=1)
                for j, st in pairs]
        seqs.append(torch.cat(commit, dim=1))          # the final sequence
        context = s.contexts[out['ctx']][rows]
        gen = torch.Generator(device=device).manual_seed(
            s.run.rng_seed('control'))
        modes = [None] + ([CONTROL] if s.run.control is not None else [])
        for lowp in modes:
            judged, kv = _judged(W, p, tr, context, seqs, lowp, layers, gen,
                                 picks=lowp is not None)
            if lowp is None:
                want, want_kv = judged, kv
            gaps, kls, miss = [], [], []
            for (j, st), (lg, pick), (ref_lg, _) in zip(pairs, judged, want):
                cur = ids[j * (steps + 1) + st][rows]
                nxt = ids[j * (steps + 1) + st + 1][rows]
                if lowp is None:
                    prog = out['logits'].get((j, st))
                    if prog is None:
                        gaps.append(nan)
                        continue
                    prog, chosen = prog.float(), nxt
                else:
                    prog, chosen = lg, pick
                gaps.append(_rel(prog, ref_lg))
                kls.append(_kl(ref_lg, prog))
                pos = (cur == mask_id) & (nxt != mask_id)
                kth = torch.topk(ref_lg, tr['topk'], dim=-1).values[..., -1]
                val = ref_lg.gather(-1, chosen.clamp(max=mask_id - 1)
                                    .long()[..., None])[..., 0]
                miss.append((val < kth)[pos].float())
            cache = []
            for i in layers:
                prog_kv = out['kv'].get(i) if lowp is None else kv[i]
                if prog_kv is None:
                    cache.append(nan)
                    continue
                cache += [_rel(prog_kv[0], want_kv[i][0]),
                          _rel(prog_kv[1], want_kv[i][1])]
            img_want = ref.decode(W, s1, final[rows])
            img = (out['images'][rows] if lowp is None
                   else ref.decode(W, s1, final[rows], lowp=lowp))
            vals = {'logit_gap': float(np.max(gaps)),
                    'sample_kl': float(np.mean(kls)) if kls else nan,
                    'token_miss_share': (float(torch.cat(miss).mean())
                                         if miss else nan),
                    'cache_err': float(np.max(cache)),
                    'image_err_max': float((img.float() - img_want)
                                           .abs().max())}
            if lowp is None:
                got = vals
            else:
                ctl = vals
    numbers += [(k, got[k]) for k in ('logit_gap', 'token_miss_share',
                                      'sample_kl', 'cache_err',
                                      'image_err_max')]
    numbers += [(k + '.control', v) for k, v in ctl.items()]
    limits = spec['limits']
    s.diagnostics = {'checked_call': c, 'checked_pairs': pairs,
                     'checked_layers': layers}
    return [(n_, v, limits[n_.split('.')[0]]) for n_, v in numbers]
