"""Port kernels' plain versions held against the JAX package on the CPU:
flash attention and the VQ lookup against the Pallas kernels in interpret
mode, the sampling head's top-k mask and arithmetic against the JAX math on
shared Gumbel noise.  The CUDA kernels' algorithms are held the same way
through their CPU emulations (``sample_streamed``, ``nearest_codes_tiled``)
and the sampling head's Philox generator against its published test
vectors.  On a CPU tensor each port wrapper takes its plain version and
launches nothing."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paintmind_tpu.models.quantize import l2norm as jax_l2norm
from paintmind_tpu.ops import flash_attention as jfa
from paintmind_tpu.ops import sampling as jsm
from paintmind_tpu.ops import vq_lookup as jvq
from paintmind_tpu_torch.models import quantize as tq
from paintmind_tpu_torch.ops import _build
from paintmind_tpu_torch.ops import flash_attention as tfa
from paintmind_tpu_torch.ops import sampling as tsm
from paintmind_tpu_torch.ops import vq_lookup as tvq

import _torch_dist  # noqa: F401  (the CPU-thread rule under xdist)


@pytest.fixture
def interpret_mode():
    # the jitted JAX wrappers cache per shape: the shapes below are used by
    # no other test, so the flag is honoured at trace time
    jfa._INTERPRET = True
    jvq._INTERPRET = True
    yield
    jfa._INTERPRET = False
    jvq._INTERPRET = False


@pytest.mark.parametrize('n,m', [(128, 77), (130, 40)])
def test_flash_plain_matches_jax_kernel(interpret_mode, n, m):
    """Plain K1 vs the Pallas flash kernel (interpret mode), fp32:
    mean abs error <= 1e-5; the CPU wrapper is the plain version."""
    rng = np.random.default_rng(n + m)
    q, k, v = (rng.standard_normal((2, s, 3, 64)).astype(np.float32)
               for s in (n, m, m))
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), 0.125))
    before = tfa.launches
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 0.125)
    assert out.shape == (2, n, 3, 64) and out.dtype == torch.float32
    print(f'plain flash vs Pallas (interpret) N={n} M={m}: mean abs '
          f'{np.abs(out.numpy() - ref).mean():.3e}, max abs '
          f'{np.abs(out.numpy() - ref).max():.3e}')
    assert float(np.abs(out.numpy() - ref).mean()) <= 1e-5
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-4
    assert tfa.launches == before


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n,m', [(200, 77), (128, 77), (72, 72), (128, 192)])
def test_flash_tiled_emulation(interpret_mode, n, m, dtype):
    """The tiled emulation of the bf16 K1 (64-key tiles, -inf on the columns
    past M, zero rows past N, base-2 online softmax, P rounded before P.V)
    against ``flash_attention_plain`` and the Pallas kernel in interpret
    mode, at ragged M, ragged N and more than one full key tile.  fp32:
    nothing is rounded, mean relative error <= 1e-5.  bf16: the emulation
    rounds the unnormalised p and divides by the fp32 sum afterwards, the
    other two round the normalised probabilities, so they differ by one
    bf16 rounding of values below 1: mean abs <= 1e-3 (measured 3.1e-4 at
    most), the JAX package's own bf16 gate being 5e-3.  Its log-sum-exp
    against ``torch.logsumexp`` of the fp32 scaled scores: <= 1e-5 max abs."""
    rng = np.random.default_rng(7 * n + m)
    q, k, v = (rng.standard_normal((2, s, 3, 64)).astype(np.float32)
               for s in (n, m, m))
    tdt = getattr(torch, dtype)
    tq_, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out, lse = tfa.flash_attention_tiled(tq_, tk, tv, 0.125)
    assert out.shape == (2, n, 3, 64) and out.dtype == tdt
    assert lse.shape == (2, 3, n) and lse.dtype == torch.float32
    plain = tfa.flash_attention_plain(tq_, tk, tv, 0.125).float().numpy()
    pallas = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a.float().numpy(), getattr(jnp, dtype))
          for a in (tq_, tk, tv)), 0.125).astype(jnp.float32))
    got = out.float().numpy()
    want_lse = torch.logsumexp(torch.einsum(
        'bnhd,bmhd->bhnm', tq_.float(), tk.float()) * 0.125, dim=-1)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    for name, ref in (('plain', plain), ('pallas interpret', pallas)):
        mean_abs = float(np.abs(got - ref).mean())
        print(f'tiled K1 vs {name} N={n} M={m} {dtype}: mean abs '
              f'{mean_abs:.3e}')
        if dtype == 'float32':
            assert mean_abs / float(np.abs(ref).mean()) <= 1e-5, name
        else:
            assert mean_abs <= 1e-3, name


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """A library is named by a digest of its source, of every shared header
    in ``csrc/`` and of the flags: editing a header renames every library
    (so none is loaded stale), editing one source renames only its own."""
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc, ignore=shutil.ignore_patterns('build'))
    assert list(csrc.glob('*.cuh')), 'the kernels share at least one header'
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD_DIR', csrc / 'build')
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(p.parent == csrc / 'build' for p in before.values())
    assert before == {name: _build.library_path(name)
                      for name in _build.KERNELS}
    header = next(csrc.glob('*.cuh'))
    header.write_bytes(header.read_bytes() + b'\n// edited\n')
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(after[name] != before[name] for name in _build.KERNELS)
    source = csrc / 'vq_lookup.cu'
    source.write_bytes(source.read_bytes() + b'\n// edited\n')
    last = {name: _build.library_path(name) for name in _build.KERNELS}
    assert last['vq_lookup'] != after['vq_lookup']
    assert last['flash_attention'] == after['flash_attention']


def test_vq_lookup_plain_matches_jax_kernel(interpret_mode):
    """Plain K2 vs the Pallas lookup kernel (interpret mode): indices equal."""
    rng = np.random.default_rng(7)
    z = np.array(jax_l2norm(jnp.asarray(
        rng.standard_normal((3, 24, 32)), jnp.float32)))
    e = np.array(jax_l2norm(jnp.asarray(
        rng.standard_normal((512, 32)), jnp.float32)))
    ref = np.asarray(jvq.fused_nearest_codes(jnp.asarray(z), jnp.asarray(e)))
    before = tvq.launches
    got = tvq.fused_nearest_codes(torch.from_numpy(z), torch.from_numpy(e))
    assert got.dtype == torch.int32 and got.shape == (3, 24)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tvq.launches == before
    # the quantizer's entry point and l2norm agree with JAX too
    zt = torch.from_numpy(rng.standard_normal((3, 24, 32)).astype(np.float32))
    np.testing.assert_allclose(tq.l2norm(zt).numpy(),
                               np.asarray(jax_l2norm(jnp.asarray(zt.numpy()))),
                               atol=1e-7)
    np.testing.assert_array_equal(
        tq.nearest_codes(torch.from_numpy(e), torch.from_numpy(z),
                         backend='plain').numpy(), ref)


def _tie_cases(rng):
    row = np.full((512,), -50.0, np.float32)
    row[:4] = [5.0, 4.0, 4.0, 4.0]
    return [
        np.tile(row, (8, 1)),  # ties straddling the k boundary
        np.array(jnp.asarray(rng.standard_normal((16, 512)) * 8,
                             jnp.bfloat16).astype(jnp.float32)),
        (rng.standard_normal((16, 512)) * 3).astype(np.float32),
        rng.integers(0, 4, (16, 512)).astype(np.float32),  # mass ties
    ]


def test_topk_keep_mask_matches_jax():
    """topk_keep_mask equal to the JAX one on the three tie cases of
    test_topk_keep_mask_exact_k_with_ties (and the boundary row): exactly k
    kept, the lowest indices among equal values."""
    rng = np.random.default_rng(0)
    for l in _tie_cases(rng):
        for k in (1, 3, 5, 25):
            got = tsm.topk_keep_mask(torch.from_numpy(l), k).numpy()
            ref = np.asarray(jsm.topk_keep_mask(jnp.asarray(l), k))
            np.testing.assert_array_equal(got, ref)
            assert (got.sum(-1) == k).all()
    boundary = _tie_cases(rng)[0]
    keep = tsm.topk_keep_mask(torch.from_numpy(boundary), 3).numpy()
    assert keep[:, :3].all() and not keep[:, 3].any()


def _jax_sample_math(l, temp, noise, k):
    """The JAX kernel's arithmetic (ops/sampling.py _sample_kernel) in jnp,
    with the Gumbel noise given instead of drawn on the core."""
    l = jnp.asarray(l, jnp.float32)
    row_max = jnp.max(l, axis=-1, keepdims=True)
    lse = jnp.log(jnp.sum(jnp.exp(l - row_max), axis=-1, keepdims=True))
    keep = jsm.topk_keep_mask(l, k)
    t = jnp.maximum(jnp.asarray(temp, jnp.float32), 1e-10)
    masked = jnp.where(keep, l / t + noise, jsm.NEG_INF)
    pred = jnp.argmax(masked, axis=-1)
    picked = jnp.take_along_axis(l, pred[..., None], axis=-1)
    return np.asarray(pred), np.asarray(jnp.exp(picked - row_max - lse)[..., 0])


@pytest.mark.parametrize('temperature', [1e-10, 0.7, 'per-sample'])
def test_sample_plain_matches_jax_math(temperature):
    """Plain K3 vs the JAX top-k mask + Gumbel argmax math on the same
    noise: pred equal, conf within 1e-6; fp32 and bf16-valued logits."""
    rng = np.random.default_rng(3)
    b, l, v, k = 3, 10, 256, 5
    for logits in _tie_cases(rng)[1:] + [
            (rng.standard_normal((b * l, v)) * 4).astype(np.float32)]:
        logits = np.resize(logits, (b, l, v)).astype(np.float32)
        key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
        noise = np.array(-jnp.log(-jnp.log(jnp.maximum(
            jax.random.uniform(key, (b, l, v)), 1e-20))))
        if temperature == 'per-sample':
            temp = np.asarray([0.5, 1.0, 2.0], np.float32)
            jtemp = temp[:, None, None]
        else:
            temp = jtemp = np.float32(temperature)
        ref_pred, ref_conf = _jax_sample_math(logits, jtemp, noise, k)
        pred, conf = tsm.gumbel_topk_sample_plain(
            torch.from_numpy(logits), torch.as_tensor(temp), k,
            torch.from_numpy(noise))
        assert pred.dtype == torch.int32 and conf.shape == (b, l)
        np.testing.assert_array_equal(pred.numpy(), ref_pred)
        assert float(np.abs(conf.numpy() - ref_conf).max()) <= 1e-6


def test_sample_wrapper_on_cpu_uses_plain_and_generator():
    """On a CPU tensor the K3 wrapper is the plain version with noise from
    the generator: same generator state, same sample; nothing launched."""
    logits = torch.randn(2, 6, 64, generator=torch.Generator().manual_seed(0))
    before = tsm.launches
    a = tsm.fused_gumbel_topk_sample(logits, 1.0, 5,
                                     generator=torch.Generator().manual_seed(1))
    noise = tsm.gumbel_noise(logits.shape,
                             generator=torch.Generator().manual_seed(1))
    b = tsm.gumbel_topk_sample_plain(logits, 1.0, 5, noise)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (top5 == a[0][..., None].long()).any(-1).all()
    assert tsm.launches == before


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """Checks that run before any build or launch: the wrappers refuse a
    device they do not support instead of falling back.  What the kernels
    take: K1 / K4 every head dim up to 128 (compiled at 64 and 128, smaller
    ones zero-padded to the next), nothing above (``attention_core`` sends
    those to the plain math, as the JAX package sends them to XLA); K2
    every code dim (compiled at 8, 16 and 32, wider ones in chunks of 64)."""
    meta = torch.empty(1, 4, 1, 64, device='meta')
    with pytest.raises(ValueError):
        tfa.flash_attention(meta, meta, meta, 0.125)
    for d in (129, 256):
        wide = torch.empty(1, 4, 1, d, device='meta')
        with pytest.raises(ValueError):
            tfa.flash_attention(wide, wide, wide, 0.125)
    assert [tfa.kernel_head_dim(d) for d in (1, 16, 32, 63, 64, 65, 100, 128)] \
        == [64, 64, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match='up to 128'):
        tfa.kernel_head_dim(129)
    assert [tvq.kernel_code_dim(d) for d in (1, 8, 9, 16, 17, 32, 33, 64, 65,
                                             100, 128, 200)] \
        == [8, 8, 16, 16, 32, 32, 64, 64, 128, 128, 128, 256]
    with pytest.raises(ValueError):
        tvq.fused_nearest_codes(torch.empty(4, 32, device='meta'),
                                torch.empty(8, 32, device='meta'))
    with pytest.raises(ValueError):
        tsm.fused_gumbel_topk_sample(torch.empty(4, 8, device='meta'), 1.0)
    # any 1 <= k <= V: k > MAX_K goes to the radix-select kernel, so only k
    # outside the row is refused (before any device check)
    for k in (0, 65):
        with pytest.raises(ValueError, match='out of range'):
            tsm.fused_gumbel_topk_sample(torch.empty(4, 64, device='meta'),
                                         1.0, k)
        with pytest.raises(ValueError, match='out of range'):
            tsm.sample_radix(torch.zeros(4, 64), 1.0, k, torch.zeros(4, 64))
    with pytest.raises(ValueError, match='device'):
        tsm.fused_gumbel_topk_sample(torch.empty(4, 64, device='meta'), 1.0, 17)
    # the warp-a-row kernel's per-lane lists hold at most 5
    with pytest.raises(ValueError, match='at most 5'):
        tsm.sample_streamed(torch.zeros(4, 64), 1.0, 6, torch.zeros(4, 64))


# ---------------------------------------------------------------------------
# K3's generator: Philox 4x32-10 in PyTorch integer arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('counter,key,want', [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """The three known-answer vectors of Philox 4x32-10 from the Random123
    distribution (kat_vectors): exact."""
    got = tsm.philox4x32([torch.tensor([c]) for c in counter],
                         [torch.tensor([k]) for k in key])
    assert tuple(int(w) for w in got) == want


def test_philox_uniform_is_a_function_of_seed_row_and_column():
    """The same (seed, row, column) gives the same number whatever the shape
    it is asked in; other rows, columns and seeds give other numbers; rows
    past 2**31 / V and seeds past 2**32 work; counter (0, 0) under seed 0
    is the first known-answer word.  Exact."""
    seed = (1 << 61) + 12345
    rows = torch.arange(6)[:, None]
    cols = torch.arange(40)[None, :]
    full = tsm.philox_uniform(seed, rows, cols)
    assert full.shape == (6, 40) and full.dtype == torch.float32
    assert torch.equal(tsm.philox_uniform(seed, 4, torch.arange(40)), full[4])
    assert torch.equal(tsm.philox_uniform(seed, torch.arange(6), 17), full[:, 17])
    assert torch.equal(tsm.philox_uniform(torch.tensor([seed]), rows, cols), full)
    assert tsm.philox_uniform(0, 0, 0).item() == (0x6627e8d5 >> 8) * 2.0 ** -24
    # no two of 240 draws equal; a seed that differs only in its high word,
    # and a row that differs only in its high word, change every one of them
    assert full.flatten().unique().numel() == 240
    assert (tsm.philox_uniform(seed ^ (1 << 40), rows, cols) != full).all()
    assert (tsm.philox_uniform(seed, rows + (1 << 33), cols) != full).all()
    gumbel = tsm.philox_gumbel(seed, (2, 3, 40))
    want = -torch.log(-torch.log(torch.clamp(full, min=1e-20)))
    assert torch.equal(gumbel.reshape(6, 40), want)


def test_philox_uniform_distribution():
    """u lies in [0, 1) on the 24-bit grid; mean and variance of 10**5
    draws within 3 sigma of 1/2 and 1/12."""
    n = 100_000
    u = tsm.philox_uniform(2024, torch.arange(100)[:, None],
                           torch.arange(1000)[None, :]).double().flatten()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2 ** 24, torch.round(u * 2 ** 24))
    assert abs(float(u.mean()) - 0.5) <= 3 * (1 / 12 / n) ** 0.5
    # var of the sample variance of a uniform: (1/80 - 1/144) / n
    assert abs(float(u.var()) - 1 / 12) <= 3 * ((1 / 80 - 1 / 144) / n) ** 0.5


def test_draw_seed_follows_the_generator():
    a = tsm.draw_seed(torch.Generator().manual_seed(3), 'cpu')
    b = tsm.draw_seed(torch.Generator().manual_seed(3), 'cpu')
    c = tsm.draw_seed(torch.Generator().manual_seed(4), 'cpu')
    assert a.dtype == torch.int64 and a.shape == (1,)
    assert int(a) == int(b) != int(c) and 0 <= int(a) < 2 ** 62


# ---------------------------------------------------------------------------
# K3's algorithm, lane for lane (sample_streamed)
# ---------------------------------------------------------------------------

def _stream_cases(rng):
    """The tie cases, at widths that are whole groups of chunks (512 = two
    groups of 4 x 32 fp32 chunks, 4096), ragged (500), and narrower than
    one chunk per lane (100)."""
    cases = [c[:6] for c in _tie_cases(rng)]
    cases += [c[:6, :500] for c in _tie_cases(rng)[1:]]
    cases.append((rng.standard_normal((4, 100)) * 3).astype(np.float32))
    cases.append(rng.integers(0, 3, (3, 4096)).astype(np.float32))
    cases.append((rng.standard_normal((3, 4096)) * 3).astype(np.float32))
    return cases


@pytest.mark.parametrize('k', [1, 3, 4, 5])
@pytest.mark.parametrize('vec,misalign', [(8, 0), (4, 0), (8, 3)])
def test_sample_streamed_keeps_the_topk_mask(k, vec, misalign):
    """The kernel's selection (per-lane sorted lists, the shared bound, the
    tournament merge) keeps exactly ``topk_keep_mask``'s entries, and so the
    JAX mask: equal, on every tie case, for bf16-sized and fp32-sized chunks
    and for rows that start off the 16-byte grid."""
    rng = np.random.default_rng(k)
    for l in _stream_cases(rng):
        lt = torch.from_numpy(l)
        keep = tsm.sample_streamed(lt, 1.0, k, torch.zeros_like(lt), vec=vec,
                                   misalign=misalign)[2].numpy()
        np.testing.assert_array_equal(keep, tsm.topk_keep_mask(lt, k).numpy())
        np.testing.assert_array_equal(
            keep, np.asarray(jsm.topk_keep_mask(jnp.asarray(l), k)))
        assert (keep.sum(-1) == k).all()


@pytest.mark.parametrize('temperature', [1e-10, 0.7, 'per-sample'])
@pytest.mark.parametrize('k', [1, 3, 5])
def test_sample_streamed_matches_plain_and_jax_math(temperature, k):
    """The kernel's algorithm on the kernel's own noise (``philox_gumbel``)
    against ``gumbel_topk_sample_plain`` and against the JAX kernel's
    arithmetic on the same noise: pred equal, conf within 1e-6 (the online
    base-2 log-sum-exp against one exp-sum in fp32)."""
    rng = np.random.default_rng(11)
    b, l = 3, 4
    for logits in _stream_cases(rng):
        v = logits.shape[-1]
        logits = np.resize(logits, (b, l, v)).astype(np.float32)
        noise = tsm.philox_gumbel(int(rng.integers(1 << 62)), (b, l, v))
        if temperature == 'per-sample':
            temp = np.asarray([0.5, 1.0, 2.0], np.float32)
            jtemp = temp[:, None, None]
        else:
            temp = jtemp = np.float32(temperature)
        pred, conf, _ = tsm.sample_streamed(
            torch.from_numpy(logits), torch.as_tensor(temp), k, noise,
            misalign=int(rng.integers(8)))
        assert pred.dtype == torch.int32 and conf.shape == (b, l)
        plain_pred, plain_conf = tsm.gumbel_topk_sample_plain(
            torch.from_numpy(logits), torch.as_tensor(temp), k, noise)
        jax_pred, jax_conf = _jax_sample_math(logits, jtemp, noise.numpy(), k)
        np.testing.assert_array_equal(pred.numpy(), plain_pred.numpy())
        np.testing.assert_array_equal(pred.numpy(), jax_pred)
        assert float((conf - plain_conf).abs().max()) <= 1e-6
        assert float(np.abs(conf.numpy() - jax_conf).max()) <= 1e-6


# ---------------------------------------------------------------------------
# K3r, K3's radix-select kernel, pass for pass (sample_radix)
# ---------------------------------------------------------------------------

def _radix_cases(rng):
    """The tie cases (512 wide), ragged (500), narrow (100) and rows of +0
    and -0 (300 wide), each with k = V; a wide row (4096) without it."""
    zeros = np.where(rng.random((4, 300)) < 0.5, 0.0, -0.0).astype(np.float32)
    zeros[:, ::7] = 1.0
    cases = [c[:6] for c in _tie_cases(rng)]
    cases += [c[:6, :500] for c in _tie_cases(rng)[1:]]
    cases.append((rng.standard_normal((4, 100)) * 3).astype(np.float32))
    cases.append(zeros)
    wide = [rng.integers(0, 3, (3, 4096)).astype(np.float32),
            (rng.standard_normal((3, 4096)) * 3).astype(np.float32)]
    return cases, wide


def test_order_keys_order_as_the_values():
    """The radix kernel's keys: a larger value is a larger key, equal values
    (+0 and -0 too) one key; exact over signs, magnitudes and infinities."""
    x = np.array([-np.inf, -3e38, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 2.5,
                  3e38, np.inf], np.float32)
    keys = tsm.order_keys(x)
    assert keys.dtype == np.uint32
    assert (np.diff(keys.astype(np.int64))[[i for i in range(10) if i != 4]]
            > 0).all()
    assert keys[4] == keys[5]
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(1000) * 10.0 ** rng.integers(-5, 5, 1000)).astype(
        np.float32)
    np.testing.assert_array_equal(np.argsort(tsm.order_keys(y), kind='stable'),
                                  np.argsort(y, kind='stable'))


@pytest.mark.parametrize('k', [17, 32, 100, 'V'])
def test_sample_radix_keeps_the_topk_mask(k):
    """The radix kernel's selection (radix passes over the keys, the equal
    keys admitted lowest column first) keeps exactly
    ``topk_keep_mask``'s entries, and so the JAX mask's, with ties: exact."""
    rng = np.random.default_rng(17)
    cases, wide = _radix_cases(rng)
    for l in cases + (wide if k != 'V' else []):
        kk = l.shape[-1] if k == 'V' else k
        lt = torch.from_numpy(l)
        keep = tsm.sample_radix(lt, 1.0, kk, torch.zeros_like(lt))[2].numpy()
        np.testing.assert_array_equal(keep, tsm.topk_keep_mask(lt, kk).numpy())
        np.testing.assert_array_equal(
            keep, np.asarray(jsm.topk_keep_mask(jnp.asarray(l), kk)))
        assert (keep.sum(-1) == kk).all()


@pytest.mark.parametrize('temperature', [1e-10, 0.7, 'per-sample'])
@pytest.mark.parametrize('k', [17, 32, 100, 'V'])
def test_sample_radix_matches_plain_and_jax_math(temperature, k):
    """The radix kernel's algorithm on the kernel's own noise
    (``philox_gumbel``) against ``gumbel_topk_sample_plain`` and the JAX
    kernel's arithmetic: pred equal, conf within 1e-6."""
    rng = np.random.default_rng(23)
    b, l = 3, 2
    cases, wide = _radix_cases(rng)
    for logits in cases[1::2] + (wide[1:] if k != 'V' else []):
        v = logits.shape[-1]
        kk = v if k == 'V' else k
        logits = np.resize(logits, (b, l, v)).astype(np.float32)
        noise = tsm.philox_gumbel(int(rng.integers(1 << 62)), (b, l, v))
        if temperature == 'per-sample':
            temp = np.asarray([0.5, 1.0, 2.0], np.float32)
            jtemp = temp[:, None, None]
        else:
            temp = jtemp = np.float32(temperature)
        pred, conf, _ = tsm.sample_radix(torch.from_numpy(logits),
                                         torch.as_tensor(temp), kk, noise)
        assert pred.dtype == torch.int32 and conf.shape == (b, l)
        plain_pred, plain_conf = tsm.gumbel_topk_sample_plain(
            torch.from_numpy(logits), torch.as_tensor(temp), kk, noise)
        jax_pred, jax_conf = _jax_sample_math(logits, jtemp, noise.numpy(), kk)
        np.testing.assert_array_equal(pred.numpy(), plain_pred.numpy())
        np.testing.assert_array_equal(pred.numpy(), jax_pred)
        assert float((conf - plain_conf).abs().max()) <= 1e-6
        assert float(np.abs(conf.numpy() - jax_conf).max()) <= 1e-6


def test_order_keys_16_bit_keys_order_as_bf16_values():
    """The radix kernel's 16-bit keys (bf16 values): the top half of the
    32-bit key, ordered as the values, +0 and -0 on one key, every bf16
    value (finite or not, NaN aside) on its own key."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    x = (bits << 16).view(np.float32)
    x = x[~np.isnan(x)]
    keys = tsm.order_keys(x, 16)
    assert keys.max() < 1 << 16
    np.testing.assert_array_equal(keys, tsm.order_keys(x) >> 16)
    order = np.argsort(x, kind='stable')
    assert (np.diff(keys[order].astype(np.int64)) >= 0).all()
    assert len(np.unique(keys)) == len(np.unique(x))  # +0 and -0 share one


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_sample_radix_overflow_branch(dtype):
    """Integer logits 0-3 across 4096 columns: at k = 1500 the first
    pass's bin (the value 2) puts ~2048 keys at or above it, more than the
    buffer's 1024, so every row takes the overflow branch (the later passes,
    the tie admission and the noise over the row again); at k = 17 and 32
    (the value 3, ~1024 keys) a row overflows or not by its draw.  It keeps
    exactly the JAX mask and samples as the plain version and the JAX math,
    pred equal and conf within 1e-6, at every k."""
    rng = np.random.default_rng(41)
    l = rng.integers(0, 4, (6, 4096)).astype(np.float32)
    lt = torch.from_numpy(l)
    if dtype == 'bf16':
        lt = lt.to(torch.bfloat16)
    seen = []
    for k in (17, 32, 1500):
        noise = tsm.philox_gumbel(int(rng.integers(1 << 62)), l.shape)
        pred, conf, keep, overflow = tsm.sample_radix(
            lt, 0.7, k, noise, with_overflow=True)
        seen.append(overflow.numpy())
        np.testing.assert_array_equal(
            keep.numpy(), np.asarray(jsm.topk_keep_mask(jnp.asarray(l), k)))
        plain_pred, plain_conf = tsm.gumbel_topk_sample_plain(lt, 0.7, k, noise)
        jax_pred, jax_conf = _jax_sample_math(l, np.float32(0.7), noise.numpy(), k)
        np.testing.assert_array_equal(pred.numpy(), plain_pred.numpy())
        np.testing.assert_array_equal(pred.numpy(), jax_pred)
        assert float((conf - plain_conf).abs().max()) <= 1e-6
        assert float(np.abs(conf.numpy() - jax_conf).max()) <= 1e-6
    assert seen[-1].all()


@pytest.mark.parametrize('k', [17, 32, 256])
def test_sample_radix_16_bit_key_plan(k):
    """bf16 logits through the 16-bit key plan (an 11-bit first digit, then
    5 bits over the buffer): the same kept set, pred and conf as the 32-bit
    plan on the same values in fp32, exactly the JAX mask, and pred equal to
    the plain version's and the JAX math's; the Gaussian rows stay in the
    buffer."""
    rng = np.random.default_rng(k)
    l = np.array(jnp.asarray(rng.standard_normal((8, 4096)) * 3,
                             jnp.bfloat16).astype(jnp.float32))
    l[:2, ::3] = l[:2, 5:6]  # long runs of one value: ties at the threshold
    bf = torch.from_numpy(l).to(torch.bfloat16)
    noise = tsm.philox_gumbel(int(rng.integers(1 << 62)), l.shape)
    p16, c16, k16, o16 = tsm.sample_radix(bf, 1.0, k, noise,
                                          with_overflow=True)
    p32, c32, k32 = tsm.sample_radix(torch.from_numpy(l), 1.0, k, noise)
    assert not o16[2:].any()  # the Gaussian rows stay in the buffer
    np.testing.assert_array_equal(k16.numpy(), k32.numpy())
    np.testing.assert_array_equal(
        k16.numpy(), np.asarray(jsm.topk_keep_mask(jnp.asarray(l), k)))
    assert torch.equal(p16, p32) and torch.equal(c16, c32)
    plain_pred, _ = tsm.gumbel_topk_sample_plain(bf, 1.0, k, noise)
    jax_pred, _ = _jax_sample_math(l, np.float32(1.0), noise.numpy(), k)
    np.testing.assert_array_equal(p16.numpy(), plain_pred.numpy())
    np.testing.assert_array_equal(p16.numpy(), jax_pred)


@pytest.mark.parametrize('k', [1, 3, 5])
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_sample_radix_equals_sample_streamed(k, dtype):
    """Both kernels compute one function: for k <= MAX_K the radix kernel's
    algorithm gives the warp-a-row kernel's pred, bit for bit, on the same
    Philox noise, and conf within 1e-6, on Gaussian rows, mass ties and
    ragged rows (the warp kernel's also off the 16-byte grid)."""
    rng = np.random.default_rng(100 + k)
    cases = [(rng.standard_normal((4, 4096)) * 3).astype(np.float32),
             rng.integers(0, 4, (4, 1000)).astype(np.float32),
             (rng.standard_normal((4, 500)) * 3).astype(np.float32)]
    for l in cases:
        lt = torch.from_numpy(l)
        if dtype == 'bf16':
            lt = lt.to(torch.bfloat16)
        noise = tsm.philox_gumbel(int(rng.integers(1 << 62)), l.shape)
        pred, conf, keep = tsm.sample_radix(lt, 0.8, k, noise)
        for misalign in (0, 3):
            spred, sconf, skeep = tsm.sample_streamed(lt, 0.8, k, noise,
                                                      misalign=misalign)
            assert torch.equal(pred, spred)
            assert torch.equal(keep, skeep)
            assert float((conf - sconf).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# K2's selection, thread for thread (nearest_codes_tiled)
# ---------------------------------------------------------------------------

def _lookup_case(name):
    rng = np.random.default_rng(len(name))
    t, c = {'random': (70, 640), 'duplicated rows': (66, 512),
            'ragged codebook': (130, 1000), 'one token': (1, 384)}[name]
    z = np.array(jax_l2norm(jnp.asarray(rng.standard_normal((t, 32)),
                                        jnp.float32)))
    e = np.array(jax_l2norm(jnp.asarray(rng.standard_normal((c, 32)),
                                        jnp.float32)))
    if name == 'duplicated rows':  # exact ties, four copies of each code
        e = np.tile(e[:c // 4], (4, 1))
    return z, e


@pytest.mark.parametrize('name', ['random', 'duplicated rows',
                                  'ragged codebook', 'one token'])
def test_nearest_codes_tiled_matches_plain_and_jax_kernel(interpret_mode, name):
    """The kernel's tiling, per-thread fold, merges and codebook splits give
    ``nearest_codes_plain``'s indices and the Pallas kernel's (interpret
    mode), exactly, for every number of splits: on duplicated codebook rows
    the lowest index wins through every merge and every split."""
    z, e = _lookup_case(name)
    zt, et = torch.from_numpy(z), torch.from_numpy(e)
    ref = tvq.nearest_codes_plain(zt, et)
    pallas = np.asarray(jvq.fused_nearest_codes(jnp.asarray(z), jnp.asarray(e)))
    np.testing.assert_array_equal(ref.numpy(), pallas)
    if name == 'duplicated rows':
        assert int(ref.max()) < e.shape[0] // 4
    tiles = -(-e.shape[0] // tvq.TILE_CODES)
    for splits in range(1, tiles + 1):
        got = tvq.nearest_codes_tiled(zt, et, splits)
        assert got.dtype == torch.int32 and got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref.numpy(), err_msg=str(splits))
    with pytest.raises(ValueError):
        tvq.nearest_codes_tiled(zt, et, tiles + 1)


def test_lookup_key_orders_as_score_then_lower_index():
    """The 64-bit key of the split merge: its score bits are monotone over
    negative, zero and positive floats (-0 and +0 equal), and among equal
    scores the lower index has the greater key."""
    scores = np.array([-np.inf, -3.5, -1.0, -1e-38, -1e-45, -0.0, 0.0, 1e-45,
                       1e-38, 0.5, 1.0, 1.0000001, 7.0, np.inf], np.float32)
    bits = tvq.ordered_bits(scores).astype(np.int64)
    assert bits[5] == bits[6]
    assert (np.diff(np.delete(bits, 5)) > 0).all()
    keys = tvq.pack_key(scores[:, None], np.arange(4)[None, :])
    assert keys.dtype == np.uint64 and (keys > 0).all()
    assert (np.diff(keys.astype(object), axis=1) < 0).all()  # index up, key down
    order = np.argsort(keys.astype(object).flatten())[::-1]
    assert order[0] == 13 * 4 + 0  # +inf at index 0
    assert {int(order[-1]), int(order[-2])} <= set(range(4))  # -inf last


@pytest.mark.parametrize('t,c,want', [(8192, 8192, 2), (1024, 8192, 16),
                                      (1, 8192, 64), (1, 100, 1),
                                      (100_000, 8192, 1)])
def test_codebook_splits_fill_the_card(t, c, want):
    """About two blocks per SM (132 on an H100), never more splits than
    codebook tiles, one when the token tiles alone fill the card."""
    assert tvq.codebook_splits(t, c, 132) == want


# ---------------------------------------------------------------------------
# Head dims and code dims other than the main path's (64, 32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('d', [16, 32, 128])
def test_flash_tiled_emulations_at_other_head_dims(interpret_mode, d, dtype):
    """The tiled emulations zero-pad the head dim to the compiled one (64 or
    128) as the wrappers do, and give the plain versions' results and the
    Pallas forward's (interpret mode, which takes any head dim) at N = 72,
    M = 77: forward fp32 <= 1e-5 mean relative, bf16 <= 1e-3 mean abs (one
    bf16 rounding of the probabilities, as at head dim 64); backward against
    ``flash_attention_backward_plain`` <= 1e-5 mean relative in fp32 and
    <= 1e-4 in bf16 (both round P and dS at the same places)."""
    rng = np.random.default_rng(d)
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, s, 2, d)).astype(
        np.float32)).to(tdt) for s in (72, 77, 77, 72))
    scale = d ** -0.5
    out, lse = tfa.flash_attention_tiled(q, k, v, scale)
    assert out.shape == q.shape and out.dtype == tdt
    plain = tfa.flash_attention_plain(q, k, v, scale).float().numpy()
    pallas = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a.float().numpy(), getattr(jnp, dtype))
          for a in (q, k, v)), scale).astype(jnp.float32))
    for ref in (plain, pallas):
        err = float(np.abs(out.float().numpy() - ref).mean())
        if dtype == 'float32':
            assert err / float(np.abs(ref).mean()) <= 1e-5
        else:
            assert err <= 1e-3
    got = tfa.flash_attention_backward_tiled(q, k, v, g, scale, lse)
    want = tfa.flash_attention_backward_plain(q, k, v, g, scale)
    gate = 1e-5 if dtype == 'float32' else 1e-4
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == tdt
        rel = float((a.float() - b.float()).abs().mean() / b.float().abs().mean())
        assert rel <= gate


def test_attention_auto_follows_the_jax_head_dim_rule(monkeypatch):
    """'auto' sends a head dim the JAX package's ``_flash_ok`` sends to its
    kernel (<= 128) to the K1 wrapper and a larger one to the plain math,
    as JAX sends it to XLA; 'flash' asks for the kernel whatever the head
    dim.  On the CPU both give the plain result."""
    from paintmind_tpu.nn import attention as jattn
    from paintmind_tpu_torch.nn import attention as tattn
    calls = []

    def spy(q, k, v, scale):
        calls.append(q.shape[-1])
        return tfa.flash_attention_plain(q, k, v, scale)

    monkeypatch.setattr(tattn, 'flash_attention', spy)
    for d in (16, 64, 128, 160, 256):
        q = torch.randn(1, 128, 2, d, generator=torch.Generator().manual_seed(d))
        calls.clear()
        out = tattn.attention_core(q, q, q, d ** -0.5, 'auto')
        assert (calls == [d]) == bool(jattn._flash_ok(
            jnp.zeros(q.shape), jnp.zeros(q.shape)))
        assert torch.equal(out, tfa.flash_attention_plain(q, q, q, d ** -0.5))
        calls.clear()
        tattn.attention_core(q, q, q, d ** -0.5, 'flash')
        assert calls == [d]


@pytest.mark.parametrize('dim', [8, 12, 48])
def test_nearest_codes_at_other_code_dims(interpret_mode, dim):
    """At code dims 8 (compiled), 12 (zero-padded to 16) and 48 (padded to
    64, the chunked kernel): the plain version, the kernel's selection on
    the CPU with every number of codebook splits, and the Pallas kernel in
    interpret mode give the same indices, also on duplicated codebook rows
    (the lowest index wins); zero-padding the operands changes no index."""
    rng = np.random.default_rng(dim)
    z = np.array(jax_l2norm(jnp.asarray(rng.standard_normal((130, dim)),
                                        jnp.float32)))
    e = np.array(jax_l2norm(jnp.asarray(rng.standard_normal((96, dim)),
                                        jnp.float32)))
    e = np.tile(e, (3, 1))  # exact ties: three copies of each code
    zt, et = torch.from_numpy(z), torch.from_numpy(e)
    ref = tvq.nearest_codes_plain(zt, et)
    pallas = np.asarray(jvq.fused_nearest_codes(jnp.asarray(z), jnp.asarray(e)))
    np.testing.assert_array_equal(ref.numpy(), pallas)
    assert int(ref.max()) < 96
    pad = tvq.kernel_code_dim(dim) - dim
    padded = [torch.nn.functional.pad(t, (0, pad)) for t in (zt, et)]
    for splits in (1, 2, 3):
        for args in ((zt, et), padded):
            np.testing.assert_array_equal(
                tvq.nearest_codes_tiled(*args, splits).numpy(), ref.numpy())
