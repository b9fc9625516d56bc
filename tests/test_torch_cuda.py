"""The port's CUDA kernels and device codec on the card (marker ``cuda``).

Each kernel against its plain torch version on the same device tensors,
exactly (the cone scan also in its masked mode); the device codec against
the CPU codec (SHRK bytes) and against the reference codec
(``repro.core``, which needs numpy and not JAX, so this file runs on a
card machine without JAX), on rectangular and ragged batches; the tensor
codec (its base fit too), the KV store, a streamed SHRKS container and the
analytics engine on the card against the CPU; the flash-attention,
interval-stats and ladder (pyramid quant and reconstruct) kernels against
their plain versions, the fused segment query step against its plain
version, the reduced models of every family (MLA and MoE, RG-LRU,
RWKV, cross-attention and the encoder) and the serve launcher on the card
against the CPU route, the flash kernel at MLA's head dim with V padded,
and the MoE's fixed summation order (bitwise the same twice); for
training, the forward's lse against torch.logsumexp (and the output's bits
with and without it), the flash backward kernel pair against autograd
through the plain version on both routes (and the same bits twice), the
raw forward kernel raising on an input that requires grad, and the train step's gradients on the card
(the same bits twice, near the CPU route's); for the parallel layer, on a
one-rank NCCL mesh, the data-parallel step bit-equal to the one-device
step, the expert-parallel prefill bit-equal to the dense one, the
cross-pod exchange bit-equal to ``compressed_psum_tree`` and a checkpoint
restored onto the mesh; for the dry run, the cost counter's count of the
flash kernels and of a reduced train step and prefill on the card equal to
its count on meta tensors; and the paper's baselines on the card, their
blobs equal to the CPU route's and their decodes to the CPU route's bit for
bit.  Without a card every test
here skips; run them on one with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro.core as R

import repro_torch.core as P
from repro_torch.core import entropy
from repro_torch.core import tensorshrink as T
from repro_torch.core.phases import fluctuation_table
from repro_torch.kernels import base_fit as BF
from repro_torch.kernels import cone_scan as cs_mod
from repro_torch.kernels import dequant as DQ
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import interval_stats as IS
from repro_torch.kernels import ops
from repro_torch.kernels import rans
from repro_torch.kernels import residual_quant as RQ
from repro_torch.kernels import segment_agg as SA
from repro_torch.models.layers import AttnCache
from repro_torch.serving import kvcache

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _walk(seed: int, s: int, t: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * 0.1, 4)


def _hard_cone_cases(t_len: int, s: int, seed: int = 0):
    """x, eps [T, S] float64 and lengths [S] for the window scan's hard
    spots: 0 breaks at every step (eps = -1 crosses every pair of
    candidates); 1, 2 and 3 jump at the last and first steps of windows of
    ``WINDOW`` and at lane-run edges; 4 and 5 give cand_hi == 3 and
    cand_lo == 3 at every step; 6 breaks every second step; 7, 8 and 9 have
    lengths 0, 1 and min(T, 300), 9 breaking at every step up to it; 10
    holds a NaN sample (its candidates compare false); the rest are walks."""
    w = cs_mod.WINDOW
    rng = np.random.default_rng(seed)
    t = np.arange(t_len, dtype=np.float64)
    x = np.cumsum(rng.integers(-3, 4, (t_len, s)), axis=0).astype(np.float64)
    e = np.full((t_len, s), 2.0)
    ln = np.full(s, t_len, np.int32)
    e[:, 0] = -1.0
    for col, jumps in ((1, (w - 1, 2 * w - 1, 3 * w - 1)), (2, (w, 2 * w, 3 * w)),
                       (3, (8, 15, 31, 40, w - 1, w + 1, 2 * w - 1, 2 * w + 1))):
        x[:, col] = 0.0
        for j in jumps:
            x[j:, col] += 100.0
        e[:, col] = 1.0
    x[:, 4], e[:, 4] = np.where(t > 0, 3 * t - 1, 0), 1.0
    x[:, 5], e[:, 5] = np.where(t > 0, 3 * t + 1, 0), 1.0
    x[:, 6], e[:, 6] = 10.0 * (np.arange(t_len) % 2), 0.5
    ln[7], ln[8], ln[9] = 0, 1, min(t_len, 300)
    e[:, 9] = -1.0
    if s > 10:
        x[t_len // 2 + 1 :: 97, 10] = np.nan
    return x, e, ln


def _signed_zero_cone_case(dtype):
    """Candidates that round to -0.0 and +0.0 (subnormal numerators over
    dt): the scan keeps the earlier of two equal zeros, as the loop does."""
    tiny = 5e-324 if dtype == torch.float64 else 1.4e-45
    x = np.full((600, 6), -tiny)
    x[::3] = 0.0
    x[0] = -tiny
    return torch.as_tensor(x, dtype=dtype), torch.full((600, 6), tiny, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cone_scan_kernel_equals_plain(card, dtype):
    v = torch.as_tensor(_walk(0, 96, 3000), device=card)
    cfg = P.ShrinkConfig(eps_b=0.02 * float(v.max() - v.min()))
    _, eps = fluctuation_table(v, v.amax(1) - v.amin(1), cfg)
    x, e = v.T.contiguous().to(dtype), eps.T.contiguous().to(dtype)
    lengths = torch.as_tensor(
        np.random.default_rng(0).integers(1, 3001, 96), dtype=torch.int32, device=card
    )
    inputs = [(x, e, None), (x, e, lengths)]
    # the window scan's hard spots: T = 1, T < WINDOW, T no multiple of it
    # and a multiple of it; S no multiple of a block's 4 (float64) or 8
    # (float32) series
    for t_len, s in ((1, 13), (100, 13), (700, 13), (512, 10), (1100, 11)):
        hx, he, hl = (torch.as_tensor(a, device=card) for a in _hard_cone_cases(t_len, s))
        hx, he = hx.to(dtype), he.to(dtype)
        inputs += [(hx, he, None), (hx, he, hl)]
    zx, ze = (a.to(card) for a in _signed_zero_cone_case(dtype))
    inputs.append((zx, ze, None))
    for xi, ei, ln in inputs:
        before = ops.launches["cone_scan"]
        got = cs_mod.cone_scan(xi, ei, ln)
        assert ops.launches["cone_scan"] == before + 1
        want = cs_mod.cone_scan_plain(xi, ei, ln)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
            if a.is_floating_point():  # the signs of zeros too
                assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("k", [64, 17, 1])
def test_rans_kernels_equal_plain(card, k):
    rng = np.random.default_rng(k)
    lens = [k * 40 + 3, k * 40, max(1, k - 1)]
    sym = np.full((3, max(lens)), 256, dtype=np.int16)
    freqs = np.zeros((3, 256), dtype=np.int64)
    for i, n in enumerate(lens):
        row = rng.integers(0, 1 + 60 * i, n)
        sym[i, :n] = row
        freqs[i] = entropy._rans_normalize_freqs(torch.as_tensor(np.bincount(row, minlength=256)))
    s_d, f_d = torch.as_tensor(sym, device=card), torch.as_tensor(freqs, device=card)
    got = rans.encode_rows(s_d, f_d, k)
    want = rans.encode_rows(s_d.cpu(), f_d.cpu(), k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    states, words, counts = got
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    ns = torch.tensor(lens, dtype=torch.int64, device=card)
    d_got = rans.decode_rows(states, f_d, words, off, counts, ns, k)
    d_want = rans.decode_rows_plain(
        states.cpu(), f_d.cpu(), words.cpu(), off.cpu(), counts.cpu(), ns.cpu(), k,
        d_got[0].shape[1],
    )
    for a, b in zip(d_got, d_want):
        assert torch.equal(a.cpu(), b)
    for i, n in enumerate(lens):
        assert torch.equal(d_got[0][i, :n].cpu().long(), torch.as_tensor(sym[i, :n]).long())


def _encoded_rows(card, rows, k):
    """Encode symbol rows (a list of int arrays) with their normalized
    tables on the card; returns the decoder's arguments."""
    cols = max([1] + [r.size for r in rows])
    sym = np.full((len(rows), cols), 256, dtype=np.int16)
    freqs = np.zeros((len(rows), 256), dtype=np.int64)
    for i, row in enumerate(rows):
        sym[i, : row.size] = row
        if row.size:
            freqs[i] = entropy._rans_normalize_freqs(
                torch.as_tensor(np.bincount(row, minlength=256)))
    f_d = torch.as_tensor(freqs, device=card)
    states, words, counts = rans.encode_rows(torch.as_tensor(sym, device=card), f_d, k)
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    ns = torch.tensor([r.size for r in rows], dtype=torch.int64, device=card)
    return states, f_d, words, off, counts, ns


def _decode_equals_plain(args, k, rows=None):
    """The kernel (its output allocated over freed memory full of 0xAB, so a
    cell it left unwritten shows) against the plain version; with ``rows``
    also the symbols themselves."""
    states, f_d, words, off, cnt, ns = args
    cols = int((-(-ns // k)).max()) * k
    junk = torch.full((states.shape[0], cols + 64), 0xAB, dtype=torch.uint8, device=f_d.device)
    del junk
    before = ops.launches["rans_decode"]
    got = rans.decode_rows(states, f_d, words, off, cnt, ns, k, cols=cols)
    assert ops.launches["rans_decode"] == before + 1
    want = rans.decode_rows_plain(*(t.cpu() for t in args), k, cols)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    for i, row in enumerate(rows or []):
        assert np.array_equal(got[0][i, : row.size].cpu().numpy(), row)
    return got


@pytest.mark.parametrize("k", [1, 17, 33, 64])
def test_rans_decode_kernel_mixed_rows_equal_plain(card, k):
    """44 rows of mixed lengths (4 empty, some shorter than k) and tables."""
    rng = np.random.default_rng(100 + k)
    lens = [0, 0, 0, 0, 1, k - 1 if k > 1 else 2, k, k + 1] + list(rng.integers(1, 60 * k, 36))
    rows = [rng.integers(0, int(rng.integers(1, 257)), n) for n in lens]
    _decode_equals_plain(_encoded_rows(card, rows, k), k, rows)


def test_rans_decode_kernel_long_row_and_skewed_tables(card):
    """A row of 64 lanes x 5000 steps (its words pass the shared ring many
    times), a table with one symbol at 4095 of 4096 slots and one with a
    single symbol at 4096 (the identity transform), beside a uniform one."""
    rng = np.random.default_rng(7)
    skew = np.full(9000, 7)
    skew[4321] = 200
    rows = [rng.integers(0, 256, 64 * 5000), skew, np.full(3000, 42), rng.integers(0, 256, 640)]
    args = _encoded_rows(card, rows, 64)
    assert args[1][1].max() == 4095 and args[1][2].max() == 4096
    assert int(args[4][0]) > 2 * 512  # more words than the ring holds
    _decode_equals_plain(args, 64, rows)


@pytest.mark.parametrize("k", [64, 33])
def test_rans_decode_kernel_short_words_equal_plain(card, k):
    """Word streams cut short: words past word_cnt read as 0 in both
    versions, and used exceeds word_cnt."""
    rng = np.random.default_rng(k)
    rows = [rng.integers(0, 256, 40 * k), rng.integers(0, 16, 10 * k), rng.integers(0, 256, 3)]
    states, f_d, words, off, cnt, ns = _encoded_rows(card, rows, k)
    short = (cnt - torch.tensor([7, 1, 0], device=card)).clamp(min=0)
    _, used = _decode_equals_plain((states, f_d, words, off, short, ns), k)
    assert bool((used[:2] > short[:2]).all())


def test_device_codec_bytes_equal_cpu_and_reference(card):
    v = _walk(1, 12, 4096)
    tiers = [1e-1, 1e-2, 1e-3, 0.0]
    dev = P.ShrinkCodec.from_fraction(v, frac=0.05, backend="rans", device=card)
    cpu = P.ShrinkCodec(dev.config, backend="rans", device="cpu")
    ref = R.ShrinkCodec.from_fraction(v, frac=0.05, backend="rans")
    ops.reset_launches()
    got = [P.cs_to_bytes(cs) for cs in dev.compress_batch(v, tiers, decimals=4)]
    assert all(ops.launches[name] > 0 for name in ("cone_scan", "rans_encode"))
    assert got == [P.cs_to_bytes(cs) for cs in cpu.compress_batch(v, tiers, decimals=4)]
    assert got == [R.cs_to_bytes(cs) for cs in ref.compress_batch(v, tiers, decimals=4)]
    for i, blob in enumerate(got):
        cs = P.cs_from_bytes(blob)
        out = dev.decompress_at(cs, 0.0)
        assert out.device.type == "cuda" and out.dtype == torch.float64
        np.testing.assert_array_equal(out.cpu().numpy(), v[i])
        np.testing.assert_array_equal(
            dev.decompress_at(cs, 3e-3).cpu().numpy(), R.decompress_at(R.cs_from_bytes(blob), 3e-3)
        )
    assert ops.launches["rans_decode"] > 0


def test_ragged_best_codec_bytes_equal_cpu_and_reference(card):
    rng = np.random.default_rng(2)
    lengths = [0, 1, 7, 63, 64, 65, 500, 4000, 12000, 2, 900, 3000]
    arrs = [np.round(np.cumsum(rng.standard_normal(n)) * 0.1, 4) for n in lengths]
    tiers = [1e-1, 1e-2, 1e-3, 0.0]
    allv = np.concatenate(arrs)
    dev = P.ShrinkCodec.from_fraction(allv, frac=0.05, device=card)
    ref = R.ShrinkCodec.from_fraction(allv, frac=0.05)
    ops.reset_launches()
    got = [P.cs_to_bytes(cs) for cs in dev.compress_batch(arrs, tiers, decimals=4)]
    assert ops.launches["cone_scan"] > 0
    cpu = P.ShrinkCodec(dev.config, device="cpu")
    assert got == [P.cs_to_bytes(cs) for cs in cpu.compress_batch(arrs, tiers, decimals=4)]
    assert got == [R.cs_to_bytes(cs) for cs in ref.compress_batch(arrs, tiers, decimals=4)]
    for blob, v in zip(got, arrs):
        out = dev.decompress_at(P.cs_from_bytes(blob), 0.0)
        np.testing.assert_array_equal(out.cpu().numpy(), v)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("n", [256, 130])
def test_residual_quant_and_dequant_kernels_equal_plain(card, dtype, n):
    g = torch.Generator(device="cuda").manual_seed(n)
    m = 3001
    x = torch.randn((m, n), device=card, generator=g) * 3
    theta = torch.randn((m, 1), device=card, generator=g).to(torch.bfloat16).float()
    slope = (torch.randn((m, 1), device=card, generator=g) * 0.01).to(torch.bfloat16).float()
    step = torch.rand((m, 1), device=card, generator=g) * 0.05 + 1e-3
    lengths = torch.randint(0, n + 1, (m,), device=card, generator=g)
    for ln in (None, lengths):
        before = dict(ops.launches)
        q, err = ops.residual_quant(x, theta, slope, step, 127, ln, dtype)
        out = ops.dequant(q, theta, slope, step)
        assert ops.launches["residual_quant"] == before["residual_quant"] + 1
        assert ops.launches["dequant"] == before["dequant"] + 1
        q_p, err_p = RQ.residual_quant_plain(x, theta, slope, step, 127, ln, dtype)
        assert q.dtype == dtype and torch.equal(q, q_p) and torch.equal(err, err_p)
        assert torch.equal(out, DQ.dequant_plain(q, theta, slope, step))
        # and the card equals the CPU's plain version
        q_c, err_c = RQ.residual_quant_plain(
            x.cpu(), theta.cpu(), slope.cpu(), step.cpu(), 127, None if ln is None else ln.cpu(),
            dtype,
        )
        assert torch.equal(q.cpu(), q_c) and torch.equal(err.cpu(), err_c)


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32)  # compares the signs of zeros too


@pytest.mark.parametrize("k", [256, 130, 100, 20, 876, 1024, 7, 32, 33])
def test_base_fit_kernel_equals_plain(card, k):
    # 1003 rows: no multiple of 8 or of a tile's rows; 1, 5 and 13 rows:
    # fewer than a tile (32 rows up to K = 256, 8 at K = 1024); 40: whole
    # tiles of 8 rows only
    for m in (1003, 1, 5, 13, 40):
        g = torch.Generator(device="cuda").manual_seed(k * m)
        xb = torch.randn((m, k), device=card, generator=g)
        xb = xb * torch.exp(torch.randn((m, 1), device=card, generator=g) * 2)
        if m > 2:
            xb[1] = -0.0
            xb[2, ::3] = 0.0
            xb[2, 1::3] = -0.0
        # the same rows 4 bytes off a 16-byte boundary: the scalar-load path
        shifted = torch.cat([xb.new_zeros(1), xb.reshape(-1)])[1:].view(m, k)
        want = BF.base_fit_plain(xb)
        want_cpu = BF.base_fit_plain(xb.cpu())
        for rows in (xb, shifted):
            before = ops.launches["base_fit"]
            got = ops.base_fit(rows)
            assert ops.launches["base_fit"] == before + 1
            for a, b, c in zip(got, want, want_cpu):
                assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a.cpu()), _bits(c))


@pytest.mark.parametrize("k", [1, 7, 33, 59, 60, 63, 64, 66, 70, 72, 77, 128, 256, 520, 575, 576,
                               876, 877, 1024])
def test_base_fit_kernel_single_row_equals_plain(card, k):
    """A [1, K] block takes the single-row order (XLA's vector dot) in the
    kernel's M == 1 branch and in the plain version, on the card and off
    (K = 1 divides 0 by 0: each device gives its own NaN bits)."""
    g = torch.Generator(device="cuda").manual_seed(k)
    for scale in (1.0, 1e-3, 1e4):
        xb = torch.randn((1, k), device=card, generator=g) * scale
        if scale == 1e4:
            xb[0, ::3] = -0.0
        before = ops.launches["base_fit"]
        got = ops.base_fit(xb)
        assert ops.launches["base_fit"] == before + 1
        for a, b, c in zip(got, BF.base_fit_plain(xb), BF.base_fit_plain(xb.cpu())):
            assert torch.equal(_bits(a), _bits(b))
            a = a.cpu()
            assert torch.equal(_bits(a), _bits(c)) or bool((a.isnan() & c.isnan()).all())


def test_base_fit_kernel_refuses_blocks_over_1024(card):
    with pytest.raises(ValueError, match="1024"):
        ops.base_fit(torch.zeros((8, 1025), device=card))


def test_kv_store_on_card_equals_cpu(card):
    rng = np.random.default_rng(3)
    shape = (2, 2, 64, 4, 128)
    scale = np.exp(rng.standard_normal(128) * 0.7)
    k = torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(torch.bfloat16)
    v = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32).to(torch.bfloat16)
    kpos = torch.arange(64, dtype=torch.int32).expand(2, 2, 64).contiguous()
    caches = {"prefix": [], "groups": {"pos0": {"self": AttnCache(k, v, kpos)}}, "tail": []}
    out = {}
    for dev in (card, torch.device("cpu")):
        moved = {"prefix": [], "groups": {"pos0": {"self": AttnCache(
            k.to(dev), v.to(dev), kpos.to(dev))}}, "tail": []}
        cache = kvcache.promote_caches(moved, 96)["groups"]["pos0"]["self"]
        q = kvcache.quantize_cache(cache)
        out[dev.type] = (q, kvcache.dequantize_cache(q))
    (qg, bg), (qc, bc) = out["cuda"], out["cpu"]
    for a, b in ((qg.k, qc.k), (qg.v, qc.v)):
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x.cpu(), y)
    for name in ("k", "v", "kpos"):
        assert torch.equal(getattr(bg, name).cpu(), getattr(bc, name))
    assert qg.memory_bits() == qc.memory_bits()
    assert caches["groups"]["pos0"]["self"].k.shape[2] == 64
    assert T.decompress_tensor(qg.k).device.type == "cuda"


_INT = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}


def _with_specials(x: torch.Tensor) -> torch.Tensor:
    """x with NaNs (payloads and signs too), both zeros and infinities
    scattered over some windows."""
    x = x.clone()
    t, s = x.shape
    bits = x.view(_INT[x.dtype])
    words = {torch.float32: [0x7FC00123, -0x400000, 0x7F800001],
             torch.float64: [0x7FF8000000000123, -0x8000000000000, 0x7FF0000000000001],
             torch.bfloat16: [0x7FC1, -0x40, 0x7F81]}[x.dtype]
    for i, w in enumerate(words):
        bits[(5 + 11 * i) % t, (3 * i) % s] = w
    x[:, (1 % s)] = 0.0
    x[::3, (1 % s)] = -0.0
    x[1::2, (2 % s)] = -0.0
    x[(7 % t), (4 % s)] = float("inf")
    x[(9 % t), (4 % s)] = -float("inf")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("t,s,w", [(8192, 256, 1024), (96, 37, 1), (96, 37, 96), (1000, 70, 5)])
def test_interval_stats_kernel_equals_plain(card, dtype, t, s, w):
    g = torch.Generator(device="cuda").manual_seed(t + s + w)
    x = _with_specials(torch.randn((t, s), device=card, generator=g).to(dtype))
    for xi in (x, x.T.contiguous().T):  # contiguous, then a strided view
        before = ops.launches["interval_stats"]
        got = ops.interval_stats(xi, w)
        assert ops.launches["interval_stats"] == before + 1
        want = IS.interval_stats_plain(xi, w)
        want_cpu = IS.interval_stats_plain(xi.cpu(), w)
        for a, b, c in zip(got, want, want_cpu):
            assert a.shape == (t // w, s) and a.dtype == dtype
            assert torch.equal(a.view(_INT[dtype]), b.view(_INT[dtype]))
            assert torch.equal(a.cpu().view(_INT[dtype]), c.view(_INT[dtype]))
    with pytest.raises(ValueError, match="multiple"):
        ops.interval_stats(x[: t - 1], t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interval_stats_kernel_unaligned_base_equals_plain(card, dtype):
    """S a multiple of the kernel's 16-byte vector, but the base pointer one
    element off: the one-element instantiation, against the plain version,
    and the aligned copy through the vector one."""
    t, s, w = 2048, 256, 256
    g = torch.Generator(device="cuda").manual_seed(t + s + w + 1)
    x = _with_specials(torch.randn((t, s), device=card, generator=g).to(dtype))
    buf = torch.empty(t * s + 1, dtype=dtype, device=card)
    buf[1:] = x.reshape(-1)
    xi = buf[1:].view(t, s)  # contiguous, its base 2 or 4 bytes past an allocation
    assert xi.is_contiguous() and xi.data_ptr() % 16 != 0
    for xx in (xi, x):
        got = ops.interval_stats(xx, w)
        want = IS.interval_stats_plain(xx, w)
        for a, b in zip(got, want):
            assert torch.equal(a.view(_INT[dtype]), b.view(_INT[dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [256, 130, 7])
def test_pyramid_kernels_equal_plain(card, dtype, n):
    g = torch.Generator(device="cuda").manual_seed(n)
    m = 3001
    x = (torch.randn((m, n), device=card, generator=g) * 3).to(dtype)
    theta = torch.randn((m, 1), device=card, generator=g).to(dtype)
    slope = (torch.randn((m, 1), device=card, generator=g) * 0.01).to(dtype)
    steps = torch.tensor([0.5, 0.05, 0.005], dtype=torch.float64, device=card)
    lengths = torch.randint(0, n + 1, (m,), device=card, generator=g)
    for ln in (None, lengths):
        before = dict(ops.launches)
        qs, err = ops.pyramid_quant(x, theta, slope, steps, 16, ln)
        assert ops.launches["pyramid_quant"] == before["pyramid_quant"] + 1
        want = RQ.pyramid_quant_plain(x, theta, slope, steps, 16, ln)
        want_cpu = RQ.pyramid_quant_plain(x.cpu(), theta.cpu(), slope.cpu(), steps.cpu(), 16,
                                          None if ln is None else ln.cpu())
        assert qs.shape == (3, m, n) and bool((qs[0].abs() == 16).any())
        for a, b, c in zip((qs, err), want, want_cpu):
            assert torch.equal(_fbits(a), _fbits(b)) and torch.equal(_fbits(a.cpu()), _fbits(c))
        for k in range(3):
            out = ops.pyramid_reconstruct(qs[: k + 1], theta, slope, steps[: k + 1])
            assert ops.launches["pyramid_reconstruct"] == before["pyramid_reconstruct"] + k + 1
            plain = DQ.pyramid_reconstruct_plain(qs[: k + 1], theta, slope, steps[: k + 1])
            assert out.dtype == dtype and torch.equal(_fbits(out), _fbits(plain))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segment_agg_kernel_equals_plain(card, dtype):
    rng = np.random.default_rng(9)
    m = 5000
    a = rng.integers(0, 1 << 20, m).astype(np.float64)
    b = a + rng.integers(-8, 1 << 18, m)  # empty windows and windows past 2^17
    cols = [torch.as_tensor(x.reshape(m, 1), dtype=dtype, device=card) for x in (
        np.round(rng.standard_normal(m) * 40, 3), rng.standard_normal(m) * 1e-3, a, b)]
    cols[0][:4] = torch.tensor([[-0.0], [0.0], [-0.0], [0.0]], dtype=dtype)
    cols[1][:4] = torch.tensor([[-0.0], [-0.0], [2.0], [0.0]], dtype=dtype)
    before = ops.launches["segment_agg"]
    got = SA.segment_agg(*cols)
    assert ops.launches["segment_agg"] == before + 1
    want = SA.segment_agg_plain(*cols)
    for g, w in zip(got, want):
        assert g.shape == (m, 1) and g.dtype == dtype
        assert torch.equal(_fbits(g), _fbits(w))


def _fbits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)


def _query_tables(card, seed: int, n_tables: int = 40):
    """Seeded packed segment tables on the card: lengths 1..8192, zero,
    signed-zero, negative and tiny slopes, signed-zero origins."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tables):
        k = int(rng.integers(1, 300))
        lens = rng.choice([1, 1, 2, 3, 7, 64, 700, 8192], k)
        t0s = np.concatenate([[0], np.cumsum(lens)[:-1]])
        thetas = np.round(rng.standard_normal(k) * 50, 3)
        thetas[rng.random(k) < 0.05] = -0.0
        slopes = rng.choice([0.0, -0.0, 1e-12, -1e-9, 0.25, -3.5, 0.01], k)
        out.append((int(lens.sum()), SA.pack_table(*(torch.as_tensor(x, device=card) for x in (
            t0s, lens, thetas, slopes)))))
    return out


@pytest.mark.parametrize("mode", ["aggregate", "central", "count"])
def test_segment_query_kernel_equals_plain(card, mode):
    """10^4 random parts over 40 resident tables (empty, out-of-frame and
    whole ranges included): the kernel's whole step bit-equal to the plain
    version's, and the counts equal a dense comparison of the predictions."""
    tables = _query_tables(card, 17)
    rng = np.random.default_rng(18)
    parts, desc, off = [], [], 0
    for p in range(10_000):
        n, tab = tables[int(rng.integers(0, len(tables)))]
        t0 = int(rng.integers(-20, n + 5))
        t1 = t0 + int(rng.integers(-3, 3000)) if p % 7 else n + 9
        t0c, t1c = max(t0, 0), min(t1, n)
        if t1c <= t0c:
            t0c = t1c = 0
        k = tab.shape[1]
        f1, f2 = np.float64(rng.normal() * 40), np.float64(rng.normal() * 40)
        desc.append([tab.data_ptr(), k, t0c, t1c, off, f1.view(np.int64), f2.view(np.int64), 0])
        parts.append(tab)
        off += min(k, t1c - t0c)
    desc_t = torch.tensor(desc, dtype=torch.int64, device=card)
    ops_ = ("gt", "ge", "lt", "le")
    for op in (ops_ if mode == "count" else ("gt",)):
        before = ops.launches["segment_query"]
        got = ops.segment_query(parts, desc_t, mode, op, off)
        assert ops.launches["segment_query"] == before + 1
        want = SA.segment_query_plain(parts, desc_t, mode, op, off)
        torch.cuda.synchronize()
        g = SA.query_parts(got.cpu().numpy(), np.asarray(desc), mode, off)
        w = SA.query_parts(want.cpu().numpy(), np.asarray(desc), mode, off)
        for a, b in zip(g, w):
            assert a[:4] == b[:4] and np.array_equal(a[4].view(np.int64), b[4].view(np.int64))
        if mode == "count":
            cmp = {"gt": np.greater, "ge": np.greater_equal, "lt": np.less,
                   "le": np.less_equal}[op]
            for row, tab, (i0, i1, c1, c2, _) in list(zip(desc, parts, g))[:300]:
                t = tab.cpu()
                t0s, lens = t[0].numpy(), t[1].numpy()
                th, sl = t[2].view(torch.float64).numpy(), t[3].view(torch.float64).numpy()
                pred = np.concatenate([th[j] + sl[j] * np.arange(lens[j], dtype=np.float64)
                                       for j in range(len(t0s))])[row[2] : row[3]]
                for c, cnt in ((row[5], c1), (row[6], c2)):
                    assert cnt == int(cmp(pred, np.int64(c).view(np.float64)).sum())


def test_streamed_container_and_analytics_on_card_equal_cpu(card):
    from repro_torch.analytics import AnalyticsEngine
    from repro_torch.launch import serve

    v = serve.sensor_values(4, 6000, 2)
    vrng = float(v.max() - v.min())
    tiers = [1e-2 * vrng, 1e-3 * vrng, 0.0]
    cfg = P.ShrinkConfig(eps_b=0.02 * vrng, lam=1e-4)
    blobs, answers = [], []
    for dev in (card, "cpu"):
        sc = P.ShrinkStreamCodec(cfg, tiers, decimals=4, backend="rans",
                                 value_range=(float(v.min()), float(v.max())),
                                 frame_len=1024, device=dev)
        for c0 in range(0, v.shape[1], 700):
            for sid in range(v.shape[0]):
                sc.ingest(v[sid, c0 : c0 + 700], series_id=sid)
        blobs.append(sc.finalize())
        eng = AnalyticsEngine(blobs[0], cache_frames=4, device=dev)
        ops.reset_launches()
        found: list = []
        res = serve.analytics_traffic(eng, v, 60, 1024, tiers, answers=found)
        assert res["failed"] == 0
        answers.append(([a.__dict__ for a in found], eng.stats))
        if dev == card:
            assert ops.launches["segment_query"] > 0 and ops.launches["rans_decode"] > 0
    assert blobs[0] == blobs[1]
    assert answers[0] == answers[1]
    for sid in range(4):
        got = P.decode_series(blobs[0], sid, 0.0, device=card).cpu().numpy()
        assert np.array_equal(got, R.decode_series(blobs[0], sid, 0.0))


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 256, 256, 2, 2, 128, True),
    (2, 256, 256, 2, 2, 128, False),
    (2, 512, 512, 4, 2, 64, True),
    (2, 128, 128, 2, 1, 256, True),
    (1, 128, 384, 2, 2, 64, False),
    (2, 77, 77, 4, 2, 160, True),
    (1, 200, 200, 4, 2, 16, True),
    (1, 1, 1, 8, 8, 128, True),
    (2, 128, 384, 4, 2, 128, True),
    (2, 300, 300, 8, 2, 128, True),
    (1, 1024, 1024, 32, 8, 128, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain(card, b, sq, sk, h, kv, d, causal, dtype):
    """float32 within 2e-5 and bf16 within 3e-2 (the reference's bounds for
    its kernel against its oracle), grouped queries and any length."""
    g = torch.Generator(device=card).manual_seed(sq + d)
    q = torch.randn((b, sq, h, d), device=card, generator=g).to(dtype)
    k, v = (torch.randn((b, sk, kv, d), device=card, generator=g).to(dtype) for _ in range(2))
    before = ops.launches["flash_attention"]
    got = FA.flash_attention(q, k, v, causal)
    assert ops.launches["flash_attention"] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_dense_model_on_card_equals_cpu(card):
    """Reduced llama3-8b with the same params on both routes: prefill
    through the flash kernel (one launch a layer) and decode through the
    ported _sdpa hold the CPU route's logits and caches at the bounds of
    tests/test_torch_models.py (cuBLAS and the CPU sum bf16 products in
    other orders)."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config(ARCHS["llama3-8b"])
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    on_card = _to(params, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    out = []
    for dev, p in (("cpu", params), (card, on_card)):
        ops.reset_launches()
        logits, caches = m.prefill(p, {"tokens": toks.to(dev)})
        dec = m.make_decode_caches(2, 48, device=dev)
        steps = [m.decode_step(p, toks[:, i : i + 1].to(dev), dec, i)[0] for i in range(8)]
        out.append((logits, caches["groups"]["pos0"]["self"], steps, dict(ops.launches)))
    (l0, c0, s0, _), (l1, c1, s1, launches) = out
    assert launches["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(l1.float().cpu(), l0.float(), atol=0.1, rtol=0.05)
    for f in ("k", "v"):
        torch.testing.assert_close(getattr(c1, f).float().cpu(), getattr(c0, f).float(),
                                   atol=0.05, rtol=0.02)
    assert torch.equal(c1.kpos.cpu(), c0.kpos)
    for a, b in zip(s1, s0):
        torch.testing.assert_close(a.float().cpu(), b.float(), atol=0.1, rtol=0.05)


@pytest.mark.parametrize("b,s,h", [(2, 256, 4), (1, 512, 16)])
def test_flash_attention_at_mla_head_dim_with_padded_v(card, b, s, h):
    """MLA's prefill shape: q and k at nope + rope = 192, V of 128 padded
    with zeros to 192.  The kernel within 3e-2 of its plain version, the
    padded columns zero and the first 128 those of an unpadded attention."""
    g = torch.Generator(device=card).manual_seed(s + h)
    q, k = (torch.randn((b, s, h, 192), device=card, generator=g).bfloat16() for _ in range(2))
    v = torch.randn((b, s, h, 128), device=card, generator=g).bfloat16()
    v_pad = torch.nn.functional.pad(v, (0, 64))
    got = FA.flash_attention(q, k, v_pad, True)
    want = FA.flash_attention_plain(q, k, v_pad, True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(qf, kf, vf, is_causal=True,
                                                           scale=192**-0.5).transpose(1, 2)
    torch.testing.assert_close(got[..., :128].float(), ref, atol=3e-2, rtol=3e-2)


def test_moe_apply_on_card_is_deterministic(card):
    """The dispatch writes each kept row once and the gather adds a token's
    k contributions in slot order, so two runs on the card are bitwise
    equal; the card holds the CPU route within atol 2**-4, rtol 2**-7
    (cuBLAS and the CPU sum the bf16 expert products in other orders)."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import layers as PL

    cfg = dataclasses.replace(reduced_config(ARCHS["deepseek-v2-lite-16b"]), n_experts=16,
                              top_k=6, capacity_factor=1.0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = PL.moe_init(gen, cfg)
    x = torch.randn((4, 256, cfg.d_model), generator=gen).bfloat16()
    pc = _to(p, card)
    y1, a1 = PL.moe_apply(pc, x.to(card), cfg)
    y2, a2 = PL.moe_apply(pc, x.to(card), cfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    y0, a0 = PL.moe_apply(p, x, cfg)
    torch.testing.assert_close(a1.cpu(), a0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y1.float().cpu(), y0.float(), atol=2**-4, rtol=2**-7)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b",
                                  "recurrentgemma-9b", "rwkv6-1.6b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_model_family_on_card_equals_cpu(card, arch):
    """Each new family reduced, the same params on both routes: the
    prefill's logits and 8 decode steps' at the bounds of
    tests/test_torch_models.py; one flash launch a decoder layer (every
    layer of these archs with causal self-attention; none for RG-LRU's
    local layers and RWKV)."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config(ARCHS[arch])
    m = build_model(cfg)
    params = m.init(1, device="cpu")
    on_card = _to(params, card)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model))).float()
    elif cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(
            rng.standard_normal((2, cfg.vision_tokens, cfg.d_model))).float()
    out = []
    for dev, p in (("cpu", params), (card, on_card)):
        ops.reset_launches()
        logits, caches = m.prefill(p, {k: v.to(dev) for k, v in batch.items()})
        launches = ops.launches["flash_attention"]
        dec = m.make_decode_caches(2, 40, device=dev)
        steps = [m.decode_step(p, toks[:, i : i + 1].to(dev), dec, i)[0] for i in range(8)]
        out.append((logits, steps, launches))
    (l0, s0, _), (l1, s1, launches) = out
    flash_layers = {"hybrid": 0, "ssm": 0}.get(cfg.family, cfg.n_layers)
    assert launches == flash_layers
    torch.testing.assert_close(l1.float().cpu(), l0.float(), atol=0.1, rtol=0.05)
    for a, b in zip(s1, s0):
        torch.testing.assert_close(a.float().cpu(), b.float(), atol=0.1, rtol=0.05)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_serve_model_on_card(card, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--mode", "model", "--arch", "qwen3-0.6b", "--reduced"]) == 0
    assert "served 16 requests" in capsys.readouterr().out


def _ragged_container(dev, scope: str) -> tuple[bytes, dict]:
    from repro_torch.data.synthetic import ragged_sensor_traffic
    from repro_torch.launch import serve
    from repro_torch.serving import RaggedBatcher

    b = RaggedBatcher(P.ShrinkConfig(eps_b=0.4, lam=1e-4), eps_targets=[8e-3, 0.0], decimals=4,
                      backend="rans", flush_samples=20_000 if scope == "batch" else 3000,
                      max_buckets=4, scope=scope, device=dev)
    blob, _ = serve.ragged_ingest(b, ragged_sensor_traffic(48, 60, seed=3))
    return blob, b.stats()


@pytest.mark.parametrize("scope", ["batch", "series"])
def test_ragged_batcher_on_card_equals_cpu(card, scope):
    ops.reset_launches()
    got = _ragged_container(card, scope)
    assert ops.launches["cone_scan"] > 0 and ops.launches["rans_encode"] > 0
    assert got == _ragged_container("cpu", scope)


def _flaky_gateway_answers(dev) -> tuple[list, dict]:
    from repro_torch.launch import serve
    from repro_torch.serving import FaultTolerantGateway, RangeQuery, RetryPolicy
    from repro_torch.testing import ChaosInjector

    v = serve.sensor_values(4, 6000, 5)
    cfg = P.ShrinkConfig(eps_b=0.05 * float(v.max() - v.min()), lam=1e-4)
    sc = P.ShrinkStreamCodec(cfg, [1e-2, 1e-3, 0.0], decimals=4, backend="rans",
                             value_range=(float(v.min()), float(v.max())), frame_len=1024,
                             device=dev)
    for sid in range(4):
        sc.ingest(v[sid], series_id=sid)
    now = [0.0]

    def sleep(s):
        now[0] += s

    gw = FaultTolerantGateway(sc.finalize(), retry=RetryPolicy(max_attempts=3), max_queue=6,
                              clock=lambda: now[0], sleep=sleep, seed=3, device=dev)
    gw.frame_decode = ChaosInjector(1).flaky(gw.frame_decode, 0.3)
    qrng = np.random.default_rng(0)
    for qid in range(48):
        lo = int(qrng.integers(0, 5000))
        gw.submit(RangeQuery(qid=qid, series_id=qid % 4, t0=lo,
                             t1=lo + int(qrng.integers(1, 2500)), eps=(1e-2, 1e-3, 0.0)[qid % 3]))
    done = gw.run(deadline_s=1.0)
    return [(q.error, q.achieved, q.degraded,
             None if q.result is None else q.result.cpu().numpy().view(np.int64).tolist())
            for q in done], gw.stats


def test_gateway_with_flaky_decode_on_card_equals_cpu(card):
    ops.reset_launches()
    got = _flaky_gateway_answers(card)
    assert ops.launches["rans_decode"] > 0
    assert got == _flaky_gateway_answers("cpu")
    assert got[1]["retries"] > 0 and got[1]["shed"] > 0


def _fleet_run(dev):
    from repro_torch.launch import serve
    from repro_torch.serving import RangeQuery

    fleet, _, _, admitted, rejected = serve._ingest_fleet(
        serve._gen_traffic(24, 60, seed=1)[0], 4, 1024, device=dev)
    answers = []
    for sid in [s for s in sorted(admitted) if sum(c.size for c in admitted[s]) >= 300][:12]:
        q = fleet.query(RangeQuery(qid=sid, series_id=sid, t0=0, t1=300, eps=8e-3))
        assert q.error is None, q.error
        answers.append(q.result.cpu().numpy().view(np.int64).tolist())
        for op in ("sum", "min", "stddev"):
            answers.append(fleet.aggregate(sid, op, 5, 280, eps=8e-3).__dict__)
        answers.append(fleet.count_where(sid, "gt", 0.0, 0, 300, eps=0.0).__dict__)
    return fleet.seal(), rejected, answers, fleet.fleet_stats()


def test_four_shard_fleet_on_card_equals_cpu(card):
    ops.reset_launches()
    got = _fleet_run(card)
    for name in ("cone_scan", "rans_encode", "rans_decode", "segment_query"):
        assert ops.launches[name] > 0, name
    assert got == _fleet_run("cpu")


# ------------------------------------------- training: the flash backward
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # of the largest |gradient|


def _bwd_route(dtype, d: int) -> str:
    """The route csrc/flash_attention_bwd.cu's header gives an aligned call."""
    return "tensor cores" if dtype == torch.bfloat16 and d % 8 == 0 and d <= 192 else "scalar"


# the last field is V's width before its zero padding to d (MLA's shape)
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,vd", [
    (2, 130, 130, 4, 2, 64, True, 64), (1, 200, 77, 2, 2, 128, False, 128),
    (1, 96, 96, 4, 1, 16, True, 16), (1, 70, 70, 2, 1, 192, True, 192),
    (1, 65, 100, 2, 2, 256, False, 256), (2, 256, 256, 16, 8, 128, True, 128),
    # lengths that are not multiples of the tensor-core tiles (64 and 128)
    (1, 4097, 4097, 2, 1, 128, True, 128), (1, 4097, 200, 2, 2, 128, True, 128),
    # non-causal with Sq != Sk
    (2, 200, 4097, 4, 2, 64, False, 64), (1, 333, 520, 8, 8, 64, False, 64),
    # GQA groups of 1, 2 and 8
    (1, 256, 256, 8, 8, 128, True, 128), (1, 300, 300, 8, 4, 64, True, 64),
    (1, 300, 300, 8, 1, 128, True, 128),
    # MLA: q and k at 192, V of 128 padded with zeros to 192
    (1, 512, 512, 16, 16, 192, True, 128),
    # D % 8 != 0: the scalar route in bf16 too
    (1, 96, 96, 2, 2, 20, True, 20),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_equals_plain(card, b, sq, sk, h, kv, d, causal, vd, dtype):
    """dq, dk, dv of the kernel pair, given the forward's lse, against
    autograd through the plain version: float32 within 1e-4 and bf16 within
    3e-2 of each gradient's largest |value| (float32 sums in other orders;
    in bf16 also delta from the bf16 output and P and dS as bf16 terms of
    the tensor-core products); two launches give the same bits; the route
    is the one the kernel's header names."""
    g = torch.Generator(device=card).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), device=card, generator=g).to(dtype)
    k = torch.randn((b, sk, kv, d), device=card, generator=g).to(dtype)
    v = torch.nn.functional.pad(torch.randn((b, sk, kv, vd), device=card, generator=g),
                                (0, d - vd)).to(dtype)
    dout = torch.randn((b, sq, h, d), device=card, generator=g).to(dtype)
    dout[..., vd:] = 0  # the model cuts V's padded columns off
    out, lse = FA._flash_attention_fwd_cuda(q, k, v, causal)
    before = ops.launches["flash_attention_bwd"]
    got = FA.flash_attention_bwd(q, k, v, out, dout, causal, lse=lse)
    assert ops.launches["flash_attention_bwd"] == before + 1
    assert FA.last_route["flash_attention_bwd"] == _bwd_route(dtype, d)
    want = FA.flash_attention_bwd_plain(q, k, v, out, dout, causal)
    for x, w in zip(got, want):
        assert x.dtype == dtype and x.shape == w.shape
        err = (x.float() - w.float()).abs().max().item()
        assert err <= FLASH_BWD_TOL[dtype] * w.float().abs().max().item(), err
    again = FA.flash_attention_bwd_cuda(q, k, v, out, dout, causal, lse=lse)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _unaligned(shape, g, dev) -> torch.Tensor:
    """A contiguous bf16 tensor whose base is 2 bytes off 16."""
    n = int(np.prod(shape))
    return torch.randn(n + 1, device=dev, generator=g).bfloat16()[1:].view(shape)


def test_flash_attention_bwd_unaligned_input_takes_the_scalar_route(card):
    g = torch.Generator(device=card).manual_seed(11)
    q, dout = (_unaligned((1, 100, 4, 64), g, card) for _ in range(2))
    k, v = (torch.randn((1, 100, 2, 64), device=card, generator=g).bfloat16() for _ in range(2))
    assert q.data_ptr() % 16 and q.is_contiguous()
    out, lse = FA._flash_attention_fwd_cuda(q, k, v, True)
    assert FA.last_route["flash_attention"] == "scalar"
    got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse=lse)
    assert FA.last_route["flash_attention_bwd"] == "scalar"
    want = FA.flash_attention_bwd_plain(q, k, v, out, dout, True)
    for x, w in zip(got, want):
        assert (x.float() - w.float()).abs().max() <= 3e-2 * w.float().abs().max()


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 128),
                                     (torch.bfloat16, 64), (torch.bfloat16, 20),
                                     (torch.bfloat16, 192)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_forward_lse_equals_logsumexp(card, dtype, d, causal):
    """The forward's lse, from the tensor-core route (bf16, D % 8 == 0) and
    the scalar one, is torch.logsumexp of the plain version's scaled,
    masked scores within 1e-5 relative (and 1e-5 absolute near 0)."""
    g = torch.Generator(device=card).manual_seed(d + causal)
    sk = 300 if causal else 170
    q = torch.randn((2, 300, 4, d), device=card, generator=g).to(dtype)
    k, v = (torch.randn((2, sk, 2, d), device=card, generator=g).to(dtype) for _ in range(2))
    out, lse = FA._flash_attention_fwd_cuda(q, k, v, causal)
    want_route = "tensor cores" if dtype == torch.bfloat16 and d % 8 == 0 else "scalar"
    assert FA.last_route["flash_attention"] == want_route
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 300)
    torch.testing.assert_close(lse, FA.flash_attention_lse_plain(q, k, causal), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 128),
                                     (torch.bfloat16, 20), (torch.bfloat16, 192)])
def test_flash_attention_output_bits_do_not_depend_on_lse(card, dtype, d):
    g = torch.Generator(device=card).manual_seed(d)
    q = torch.randn((2, 333, 8, d), device=card, generator=g).to(dtype)
    k, v = (torch.randn((2, 333, 2, d), device=card, generator=g).to(dtype) for _ in range(2))
    out, lse = FA._flash_attention_fwd_cuda(q, k, v, True)
    assert lse is not None
    assert torch.equal(out, FA.flash_attention_cuda(q, k, v, True))


def test_flash_attention_autograd_on_card_and_the_raw_kernel_raises(card):
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((1, 64, 2, 32), device=card, generator=g).bfloat16()
               .requires_grad_(True) for _ in range(3))
    with pytest.raises(RuntimeError, match="records no gradient"):
        FA.flash_attention_cuda(q, k, v, True)
    with torch.no_grad():
        FA.flash_attention_cuda(q, k, v, True)  # nothing to record
    before = dict(ops.launches)
    y = ops.flash_attention(q, k, v, causal=True)
    dout = torch.randn_like(y)
    grads = torch.autograd.grad(y, (q, k, v), dout)
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    assert ops.launches["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    # the Function saved the forward's lse: the same launch by hand gives the same bits
    with torch.no_grad():
        out, lse = FA._flash_attention_fwd_cuda(q, k, v, True)
    assert torch.equal(out, y)
    want = FA.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(), y.detach(), dout,
                                       lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_train_step_on_card_is_deterministic_and_near_cpu(card):
    """Reduced qwen3-0.6b: the card's gradients are the same bits twice (no
    atomics on the path) and within 6% of each leaf's largest |gradient| of
    the CPU route's (tests/test_torch_train_step.py's bound)."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.training._tree import leaves, tree_map
    from repro_torch.training.train_step import _value_and_grad

    cfg = reduced_config(ARCHS["qwen3-0.6b"])
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    batch = {k: torch.from_numpy(a) for k, a in
             TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=128).batch_at(0).items()}
    to = lambda t: tree_map(lambda x: x.to(card), t)
    _, _, g1 = _value_and_grad(m, to(params), to(batch))
    _, _, g2 = _value_and_grad(m, to(params), to(batch))
    _, _, gc = _value_and_grad(m, params, batch)
    for a, b, c in zip(leaves(g1), leaves(g2), leaves(gc)):
        assert torch.equal(a, b)
        assert (a.cpu() - c).abs().max() <= 0.06 * c.abs().max()


# ------------------------------------------------ the parallel layer (mesh)
@pytest.fixture
def nccl_rank(card, tmp_path):
    """A one-rank NCCL group on a FileStore in the test's directory (no
    port, no environment variable), destroyed at teardown."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield card
    finally:
        dist.destroy_process_group()


def test_data_parallel_step_on_a_one_rank_nccl_mesh_is_the_one_device_step(nccl_rank):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training._tree import leaves

    cfg = reduced_config(ARCHS["qwen3-0.6b"])
    m = build_model(cfg)
    params = m.init(0, device=nccl_rank)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=128)
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    states = []
    for mesh_arg in (mesh, None):
        step, state = make_train_step(m, mesh_arg, AdamWConfig()), (params, adamw_init(params))
        ops.reset_launches()
        for s in range(2):
            batch = {k: torch.from_numpy(a).to(nccl_rank) for k, a in pipe.batch_at(s).items()}
            state = step(*state, batch)[:2]
        assert ops.launches["flash_attention_bwd"] > 0
        states.append(state)
    # the mesh step's params and moments are DTensors: one rank's shards are whole
    got = [t.to_local() if hasattr(t, "to_local") else t for t in leaves(states[0])]
    assert all(torch.equal(a, b) for a, b in zip(got, leaves(states[1]), strict=True))


@pytest.mark.parametrize("kv", [2, 1])
def test_sharded_step_on_a_one_rank_nccl_mesh_is_bit_equal(nccl_rank, kv):
    """Phase 16 (a) at a reduced qwen3-0.6b: the sharded step (FSDP
    gathers, the dense family's heads, ffn and vocab over "model", all on
    groups of one) from params placed by ``param_shardings`` is the
    one-device step bit for bit over 2 steps, and runs the flash kernels on
    its local heads; its prefill's logits and caches too."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.parallel import param_shardings
    from repro_torch.parallel.sharding import place
    from repro_torch.training import AdamWConfig, adamw_init, make_prefill_step, make_train_step
    from repro_torch.training._tree import leaves, tree_map

    cfg = dataclasses.replace(reduced_config(ARCHS["qwen3-0.6b"]), n_kv_heads=kv)
    m = build_model(cfg)
    params = m.init(0, device=nccl_rank)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=128)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    placed = tree_map(lambda p, s: place(p, *s), params, param_shardings(params, cfg, mesh))
    states, metrics = [], []
    for mesh_arg, start in ((mesh, placed), (None, params)):
        step, state = make_train_step(m, mesh_arg, AdamWConfig()), (start, adamw_init(start))
        ops.reset_launches()
        for s in range(2):
            batch = {k: torch.from_numpy(a).to(nccl_rank) for k, a in pipe.batch_at(s).items()}
            *state, last = step(*state, batch)
        assert ops.launches["flash_attention"] > 0 and ops.launches["flash_attention_bwd"] > 0
        states.append(state)
        metrics.append(last)
    got = [t.to_local() if hasattr(t, "to_local") else t for t in leaves(states[0])]
    assert all(torch.equal(a, b) for a, b in zip(got, leaves(states[1]), strict=True))
    assert all(torch.equal(metrics[0][k], metrics[1][k]) for k in metrics[1])
    tokens = {"tokens": torch.from_numpy(pipe.batch_at(0)["tokens"]).to(nccl_rank)}
    with torch.no_grad():
        a = make_prefill_step(m, mesh)(placed, tokens)
        b = make_prefill_step(m, None)(params, tokens)
    assert torch.equal(a[0].to_local(), b[0])
    assert all(torch.equal(x, y) for x, y in zip(
        [getattr(a[1]["groups"]["pos0"]["self"], f).to_local() for f in ("k", "v", "kpos")],
        [getattr(b[1]["groups"]["pos0"]["self"], f) for f in ("k", "v", "kpos")]))


@pytest.mark.parametrize("kv", [2, 1])
def test_sharded_decode_on_a_one_rank_nccl_mesh_is_bit_equal(nccl_rank, kv):
    """The sharded prefill and 4 steps of the sharded decode step (the
    reference's layout: heads, ffn and vocab over "model", caches placed by
    ``cache_specs``, all groups of one) at a reduced qwen3-0.6b, from
    params placed by ``param_shardings``, bit-equal to one device's."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch_tp_case import decode_chain

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import build_model
    from repro_torch.parallel import param_shardings
    from repro_torch.parallel.sharding import place
    from repro_torch.training import make_decode_step, make_prefill_step
    from repro_torch.training._tree import tree_map

    cfg = dataclasses.replace(reduced_config(ARCHS["qwen3-0.6b"]), n_kv_heads=kv)
    m = build_model(cfg)
    params = m.init(0, device=nccl_rank)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    placed = tree_map(lambda p, s: place(p, *s), params, param_shardings(params, cfg, mesh))
    prompt = torch.randint(0, cfg.vocab_size, (4, 128), device=nccl_rank,
                           generator=torch.Generator(device=nccl_rank).manual_seed(1))
    got = decode_chain(m, placed, make_prefill_step(m, mesh), make_decode_step(m, mesh), prompt,
                       steps=4, length=136)
    want = decode_chain(m, params, make_prefill_step(m, None), make_decode_step(m, None),
                        prompt, steps=4, length=136)
    flat = [[g[0], *g[1], *g[2], g[3], *g[4]] for g in (got, want)]
    assert all(torch.equal(a, b) for a, b in zip(*flat, strict=True))


def test_ep_prefill_on_a_one_rank_nccl_mesh_equals_the_dense_path(nccl_rank):
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import build_model
    from repro_torch.training import make_prefill_step

    cfg = dataclasses.replace(reduced_config(ARCHS["deepseek-v2-lite-16b"]), capacity_factor=1.25)
    m_ep = build_model(dataclasses.replace(cfg, moe_ep=True))
    params = m_ep.init(0, device=nccl_rank)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=nccl_rank,
                           generator=torch.Generator(device=nccl_rank).manual_seed(1))
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    with torch.inference_mode():
        got, _ = make_prefill_step(m_ep, mesh)(params, {"tokens": tokens})
        want, _ = make_prefill_step(build_model(cfg), None)(params, {"tokens": tokens})
    assert torch.equal(got.to_local(), want)


def test_crosspod_exchange_and_mesh_checkpoint_on_a_one_rank_nccl_mesh(nccl_rank, tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import build_model
    from repro_torch.parallel import param_shardings, param_specs
    from repro_torch.training import grad_compress as GC
    from repro_torch.training import load_checkpoint, save_checkpoint
    from repro_torch.training._tree import leaves, tree_map

    cfg = reduced_config(ARCHS["qwen3-0.6b"])
    params = build_model(cfg).init(0, device=nccl_rank)
    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    gen = torch.Generator(device=nccl_rank).manual_seed(3)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=nccl_rank), params)
    ef = tree_map(torch.zeros_like, grads)
    cc = GC.GradCompressConfig(min_leaf_size=1024)
    before = ops.launches["base_fit"]
    got, got_ef = GC.make_crosspod_exchange(mesh, cc, param_specs(params, cfg, mesh))(
        tree_map(lambda g: g[None], grads), ef)
    assert ops.launches["base_fit"] > before
    want, want_ef = GC.compressed_psum_tree(grads, ef, cc, group=mesh.get_group("pod"))
    assert all(torch.equal(a.to_local(), b) for a, b in zip(leaves(got) + leaves(got_ef),
                                                            leaves(want) + leaves(want_ef)))
    save_checkpoint(tmp_path / "ck", 0, params, codec="none")
    back, _ = load_checkpoint(tmp_path / "ck", params,
                              shardings=param_shardings(params, cfg, mesh))
    assert all(a.device_mesh is mesh and a.to_local().is_cuda and torch.equal(a.to_local(), b)
               for a, b in zip(leaves(back), leaves(params)))


_NO_CONTEXT_FLASH = """
import threading
import torch
from repro_torch.kernels import flash_attention as FA, ops
dev = torch.device("cuda")
for d in (64, 128):
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(s, generator=g).to(dev, torch.bfloat16).requires_grad_(True)
               for s in ((2, 300, 8, d), (2, 300, 2, d), (2, 300, 2, d)))
    out = ops.flash_attention(q, k, v, True)
    # leaves: the flash backward is the first node on autograd's device thread
    torch.autograd.grad(out, (q, k, v), torch.randn_like(out))
    torch.cuda.synchronize()
q, k, v = (t.detach() for t in (q, k, v))
want, got = FA.flash_attention_cuda(q, k, v, True), []
t = threading.Thread(target=lambda: got.append(FA.flash_attention_cuda(q, k, v, True)))
t.start()
t.join(timeout=120)
assert not t.is_alive() and torch.equal(got[0], want)
print("ok")
"""


def test_flash_kernels_on_a_thread_without_a_current_context(card):
    """TMA's tensor maps need a current context, which a thread that has
    made no CUDA call lacks: autograd's device thread when the flash
    backward is the first node of a backward pass (leaf inputs), and a
    fresh thread.  A fresh process shows it: both raised cudaError 1 there
    before the kernels made the device's primary context current."""
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-c", _NO_CONTEXT_FLASH], capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_cost_count_on_the_card_equals_meta(card, causal):
    from repro_torch.launch.cost_analysis import analyze_step

    counts = []
    for dev in ("meta", card):
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16).requires_grad_(True)
                   for shape in ((2, 300, 8, 64), (2, 300, 2, 64), (2, 300, 2, 64)))
        out, fwd = analyze_step(ops.flash_attention, q, k, v, causal)
        _, bwd = analyze_step(torch.autograd.grad, out, (q, k, v), torch.ones_like(out))
        counts.append((fwd, bwd))
    (mf, mb), (cf, cb) = counts
    assert mf == cf and mb.kernels == cb.kernels
    assert (cf.dot_count, cb.dot_count) == (0, 0)
    assert cf.kernels["flash_attention"]["calls"] == cb.kernels["flash_attention_bwd"]["calls"] == 1


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3-8b", "deepseek-v2-lite-16b"])
def test_reduced_step_cost_on_the_card_equals_meta(card, arch):
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cost_analysis import analyze_step
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_prefill_step, make_train_step

    m = build_model(reduced_config(ARCHS[arch]))
    shape = ShapeSpec("t", 128, 2, "train")
    g = torch.Generator(device=card).manual_seed(0)
    batch = {k: torch.randint(0, 500, v.shape, generator=g, device=card, dtype=v.dtype)
             for k, v in m.input_specs(shape).items()}
    meta_p, card_p = m.init_shapes(), m.init(0, device=card)
    _, meta = analyze_step(make_train_step(m), meta_p, adamw_init(meta_p), m.input_specs(shape))
    _, got = analyze_step(make_train_step(m), card_p, adamw_init(card_p), batch)
    assert (got.flops, got.bytes, got.dot_count, got.kernels) == \
        (meta.flops, meta.bytes, meta.dot_count, meta.kernels)
    with torch.no_grad():
        _, meta = analyze_step(make_prefill_step(m), meta_p, {"tokens": m.input_specs(shape)[
            "tokens"]})
        _, got = analyze_step(make_prefill_step(m), card_p, {"tokens": batch["tokens"]})
    assert (got.flops, got.bytes, got.dot_count, got.kernels) == \
        (meta.flops, meta.bytes, meta.dot_count, meta.kernels)


def test_baselines_on_the_card_equal_the_cpu_route(card):
    import repro_torch.baselines as B

    v = _walk(7, 1, 30_000)[0]
    vc, vd = torch.from_numpy(v), torch.as_tensor(v, device=card)
    span = float(v.max() - v.min())
    cases = [(B.LOSSY[n], B.LOSSY_D[n], f * span) for n in B.LOSSY for f in (1e-2, 1e-3)]
    cases += [(B.LOSSLESS[n], B.LOSSLESS_D[n], 4) for n in B.LOSSLESS]
    before = dict(ops.launches)
    for enc, dec, arg in cases:
        blob = enc(vd, arg)
        assert blob == enc(vc, arg)
        out = dec(blob)
        assert out.is_cuda and out.dtype == torch.float64
        assert torch.equal(out.cpu().view(torch.int64), dec(blob, device="cpu").view(torch.int64))
    if B.standard._zstd is None:  # TRC's byte planes through the rANS kernels
        assert ops.launches["rans_encode"] > before["rans_encode"]
        assert ops.launches["rans_decode"] > before["rans_decode"]
