"""The routed FFN's packed path (``ops/moe_experts.py``, kernel K5's plain
version and its tile emulation, and how ``nn/moe.py`` chooses it) on the
CPU, at small shapes.  The kernels themselves run on the card only
(``chip_smoke.py K5``).

Tolerances: the packed plain path against the padded one 1e-5 max abs in
fp32; in bf16 both against the fp32 result on the same bf16 weights within
1e-2 max abs (``test_torch_moe.py``'s bf16 tolerance), the packed one nearer
on average (it rounds H once, the padded path four times, so the two can
lie one bf16 step of y apart on either side); the tile emulation against
the plain version 1e-5 in fp32 and one bf16 step in bf16 (the two sum the
depth in another order)."""

import numpy as np
import pytest
import torch

from paintmind_tpu_torch.nn import moe as tmoe
from paintmind_tpu_torch.ops import moe_experts as me
from paintmind_tpu_torch.utils import profiling

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)

DIM, MLP = 16, 96   # SwiGLU hidden 64: K5a's 144-column tile is ragged


def _layer(e, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    layer = tmoe.MoESwiGLU(DIM, MLP, e)
    with torch.no_grad():
        layer.router.weight.normal_(0, 0.5, generator=g)
        for lin in (layer.experts.w12, layer.experts.w3):
            lin.init_weights_(g)
            lin.bias.normal_(0, 0.1, generator=g)
    return layer.to(dtype)


def _tokens(t, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(t, DIM, generator=g).to(dtype)


def _padded(layer, x, k, cf):
    """The same call on the padded path: a gradient recorded."""
    with torch.enable_grad():
        y, aux = tmoe.moe_swiglu(layer, x, k, cf, 'gather')
    return y.detach(), {n: v.detach() for n, v in aux.items()}


def _weights(layer):
    ex = layer.experts
    return ex.w12.weight, ex.w12.bias, ex.w3.weight, ex.w3.bias


# (T, E, k, capacity factor): T not a multiple of 128 with drops; full
# capacity; capacity 1; k = 1; ample room
PACK_CASES = [(200, 4, 2, 1.0), (130, 2, 2, 0.5), (37, 4, 2, 0.02),
              (150, 4, 1, 1.25), (60, 8, 2, 2.0)]


@pytest.mark.parametrize('t,e,k,cf', PACK_CASES)
def test_pack_rows_layout(t, e, k, cf):
    """Each expert gets ``min(count, cap)`` rows in queue order; a kept
    assignment's row is its expert's and its own; a dropped one points
    nowhere (-1); every packed row holds the token it came from."""
    layer = _layer(e, seed=t)
    x = _tokens(t, t + 1)
    with torch.no_grad():
        _, _, gate, idx, pos, keep, cap = tmoe.route(layer, x, k, cf)
    off, row_token, row = me.pack_rows_plain(idx, pos, keep, cap, e)
    assert off.dtype == row_token.dtype == row.dtype == torch.int32
    assert row_token.shape == (min(k * t, e * cap),)
    counts = torch.stack([(idx == i).sum() for i in range(e)])
    assert off.tolist() == [0] + counts.clamp(max=cap).cumsum(0).tolist()
    assert (row[~keep] == -1).all()
    rows = row[keep].long()
    assert rows.unique().numel() == rows.numel()
    assert torch.equal(rows, (off[idx[keep]] + pos[keep]).long())
    assert ((rows >= off[idx[keep]]) & (rows < off[idx[keep] + 1])).all()
    tok = torch.arange(t)[:, None].expand(t, k)
    assert torch.equal(row_token[rows], tok[keep].int())
    if cf == 1.0:
        assert (counts > cap).any() and (off[1:] - off[:-1] == cap).any()
    if cf == 0.02:
        assert cap == 1 and int(off[-1]) <= e


def test_pack_rows_expert_without_rows_and_gate_zero_hole():
    """An expert no token picks has no rows (its offsets equal); an
    assignment queued with gate 0 keeps its row (a hole nothing reads) and
    points nowhere."""
    e, t, cap = 4, 6, 4
    idx = torch.tensor([[0, 1], [1, 0], [0, 3], [1, 3], [0, 1], [3, 0]])
    pos = torch.tensor([[0, 0], [1, 3], [1, 0], [2, 1], [2, 3], [2, 4]])
    keep = pos < cap
    keep[2, 1] = False  # a gate of 0
    off, row_token, row = me.pack_rows_plain(idx, pos, keep, cap, e)
    assert off.tolist() == [0, 4, 8, 8, 11]
    assert row[2, 1] == -1 and row[5, 1] == -1
    assert row_token[8 + 0] == 2  # the hole holds its token
    assert row.tolist() == [[0, 4], [5, 3], [1, -1], [6, 9], [2, 7], [10, -1]]


@pytest.mark.parametrize('t,e,k,cf', PACK_CASES)
def test_packed_plain_path_matches_padded_fp32(t, e, k, cf):
    """fp32: the packed plain path (no gradient) against the padded path on
    the same layer and tokens: y within 1e-5 max abs, the statistics equal."""
    layer = _layer(e, seed=t)
    x = _tokens(t, t + 2)
    with torch.no_grad():
        y, aux = tmoe.moe_swiglu(layer, x, k, cf, 'gather')
    y_ref, aux_ref = _padded(layer, x, k, cf)
    assert y.shape == y_ref.shape and y.dtype == torch.float32
    assert float((y - y_ref).abs().max()) <= 1e-5
    for name in aux:
        assert torch.equal(aux[name], aux_ref[name]), name


@pytest.mark.parametrize('k', [1, 2])
def test_packed_plain_path_matches_padded_bf16(k):
    """bf16: the packed path rounds H once where the padded one rounds
    x1, x2, silu and the product.  Against the fp32 result on the same
    bf16 weights and tokens both lie within 1e-2 max abs, the packed one
    nearer on average; the routing statistics equal; bf16 out."""
    layer = _layer(4, seed=5, dtype=torch.bfloat16)
    x = _tokens(200, 6, torch.bfloat16)
    with torch.no_grad():
        y, aux = tmoe.moe_swiglu(layer, x, k, 1.0, 'gather')
        y32, _ = tmoe.moe_swiglu(layer.float(), x.float(), k, 1.0, 'gather')
    y_ref, aux_ref = _padded(layer.bfloat16(), x, k, 1.0)
    assert y.dtype == y_ref.dtype == torch.bfloat16
    err, err_ref = (y.float() - y32).abs(), (y_ref.float() - y32).abs()
    assert float(err.max()) <= 1e-2 and float(err_ref.max()) <= 1e-2
    assert float(err.mean()) < float(err_ref.mean())
    for name in aux:
        assert torch.equal(aux[name], aux_ref[name]), name
    assert float(aux['dropped']) > 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('t,e,k,cf', PACK_CASES[:3])
def test_grouped_swiglu_tiled_matches_plain(dtype, t, e, k, cf):
    """The kernels' tile schedule and epilogue (``grouped_swiglu_tiled``)
    against the plain version on the routing's packed rows: every packed
    row written once (the emulation checks), 1e-5 max abs in fp32, within
    one bf16 step in bf16."""
    layer = _layer(e, seed=t, dtype=dtype)
    x = _tokens(t, t + 3, dtype)
    with torch.no_grad():
        _, _, _, idx, pos, keep, cap = tmoe.route(layer, x, k, cf)
        off, _, xp = me.dispatch(x, idx, pos, keep, cap, e)
        got = me.grouped_swiglu_tiled(xp, off, *_weights(layer))
        ref = me.grouped_swiglu_plain(xp, off, *_weights(layer))
    rows = int(off[-1])
    assert got[rows:].isnan().all() and not got[:rows].isnan().any()
    diff = (got[:rows].float() - ref[:rows].float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        assert (diff <= 8e-3 * ref[:rows].float().abs() + 1e-3).all()


def test_grouped_swiglu_tiled_ragged_experts():
    """Experts of 0, 1, 127, 128, 129 and 300 rows (row tiles that run into
    the next expert's rows and past the packed ones), K5b's depth not a
    multiple of 64 and K5a's columns not of 144: tiled equals plain."""
    e = 6
    layer = _layer(e, seed=9)
    counts = [0, 1, 127, 128, 129, 300]
    off = torch.tensor(np.cumsum([0] + counts), dtype=torch.int32)
    xp = _tokens(int(off[-1]) + 50, 10)
    with torch.no_grad():
        got = me.grouped_swiglu_tiled(xp, off, *_weights(layer))
        ref = me.grouped_swiglu_plain(xp, off, *_weights(layer))
    rows = int(off[-1])
    assert float((got[:rows] - ref[:rows]).abs().max()) <= 1e-5
    assert got[rows:].isnan().all()


def test_combine_plain_weights_and_drops():
    """y[t] = Σ_j g[t, j] · O[row(t, j)], a dropped assignment (-1) adding
    nothing, a kept one with gate 0 adding 0."""
    o = torch.arange(12.0).reshape(4, 3)
    row = torch.tensor([[0, 2], [-1, 1], [3, -1], [-1, -1]], dtype=torch.int32)
    gate = torch.tensor([[0.5, 0.25], [0.7, 1.0], [0.0, 0.3], [0.6, 0.4]])
    y = me.combine_plain(o, row, gate)
    want = torch.stack([0.5 * o[0] + 0.25 * o[2], o[1], 0 * o[3],
                        torch.zeros(3)])
    assert torch.equal(y, want)


def test_wrappers_raise_off_cpu_and_card():
    """No fallback: a device that is neither the CPU nor a card raises."""
    x = torch.zeros(4, 8, device='meta')
    idx = torch.zeros(4, 2, dtype=torch.int64, device='meta')
    with pytest.raises(ValueError):
        me.dispatch(x, idx, idx, idx.bool(), 2, 2)
    with pytest.raises(ValueError):
        me.combine(x, torch.zeros(4, 2, dtype=torch.int32, device='meta'),
                   torch.zeros(4, 2, device='meta'))


class _Mesh:
    size, sequence = 2, False


class _OnCard:
    """What ``_packed`` reads of a tensor on the card."""
    device, requires_grad = torch.device('cuda'), False

    def __init__(self, dtype):
        self.dtype = dtype


@pytest.mark.parametrize('case', ['grad', 'input_grad', 'tp', 'route_group',
                                  'dense', 'cuda_fp32', 'no_grad', 'frozen'])
def test_path_choice(case):
    """Recording a gradient (the parameters' or the input's), expert or
    data parallelism, ``'dense'`` and fp32 or fp16 on the card take the
    padded path; no gradient, or frozen parameters, the packed one (bf16
    on the card, any type on the CPU)."""
    layer = _layer(4)
    x = _tokens(8, 1)
    want = case in ('no_grad', 'frozen')
    if case == 'tp':
        layer.tp = _Mesh()
    if case == 'route_group':
        layer.route_group = object()
    if case == 'frozen':
        layer.requires_grad_(False)
    if case == 'input_grad':
        layer.requires_grad_(False)
        x.requires_grad_(True)
    if case == 'cuda_fp32':
        with torch.no_grad():
            for dtype, packed in ((torch.float32, False),
                                  (torch.float16, False),
                                  (torch.bfloat16, True)):
                assert tmoe._packed(layer, _OnCard(dtype)) == packed
        return
    if case == 'dense':
        with torch.no_grad():
            _, calls = _count(lambda: tmoe.moe_swiglu(layer, x, 2, 1.25, 'dense'))
        assert calls == 0
        return
    grad = torch.no_grad() if case == 'no_grad' else torch.enable_grad()
    with grad:
        assert tmoe._packed(layer, x) == want
        if case not in ('tp', 'route_group'):  # those need a process group
            _, calls = _count(lambda: tmoe.moe_swiglu(layer, x, 2, 1.25, 'gather'))
            assert calls == int(want)


def _count(fn):
    profiling.reset()
    with profiling.recording():
        out = fn()
    got = profiling.snapshot()['counters'].get('pm.moe.grouped', 0)
    profiling.reset()
    return out, got


def test_counters_count_calls_and_rows():
    """``pm.moe.grouped`` counts the packed calls, ``pm.moe.rows`` their
    packed rows: the queued assignments (the kept ones, and holes queued
    with gate 0, which a seeded softmax router does not make)."""
    layer = _layer(4, seed=3)
    xs = [_tokens(200, 20), _tokens(90, 21)]
    profiling.reset()
    with profiling.recording(), torch.no_grad():
        for x in xs:
            tmoe.moe_swiglu(layer, x, 2, 1.0, 'gather')
    counters = profiling.snapshot()['counters']
    profiling.reset()
    kept = 0
    for x in xs:
        with torch.no_grad():
            _, _, _, idx, pos, keep, cap = tmoe.route(layer, x, 2, 1.0)
        kept += int(keep.sum())
    assert counters['pm.moe.grouped'] == 2
    assert counters['pm.moe.rows'] == counters['pm.moe.kept'] == kept
    assert counters['pm.moe.assignments'] == 2 * (200 + 90) > kept
