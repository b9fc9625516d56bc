"""The port's CUDA kernels and device codec on the card (marker ``cuda``).

Each kernel against its plain torch version on the same device tensors,
exactly (the cone scan also in its masked mode); the device codec against
the CPU codec (SHRK bytes) and against the reference codec
(``repro.core``, which needs numpy and not JAX, so this file runs on a
card machine without JAX), on rectangular and ragged batches; the tensor
codec (its base fit too), the KV store, a streamed SHRKS container and the
analytics engine on the card against the CPU.  Without a card every test
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cone_scan_kernel_equals_plain(card, dtype):
    v = torch.as_tensor(_walk(0, 96, 3000), device=card)
    cfg = P.ShrinkConfig(eps_b=0.02 * float(v.max() - v.min()))
    _, eps = fluctuation_table(v, v.amax(1) - v.amin(1), cfg)
    x, e = v.T.contiguous().to(dtype), eps.T.contiguous().to(dtype)
    lengths = torch.as_tensor(
        np.random.default_rng(0).integers(1, 3001, 96), dtype=torch.int32, device=card
    )
    for ln in (None, lengths):
        before = ops.launches["cone_scan"]
        got = cs_mod.cone_scan(x, e, ln)
        assert ops.launches["cone_scan"] == before + 1
        want = cs_mod.cone_scan_plain(x, e, ln)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


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


@pytest.mark.parametrize("k", [256, 130, 100, 20, 876, 1024, 7])
def test_base_fit_kernel_equals_plain(card, k):
    g = torch.Generator(device="cuda").manual_seed(k)
    m = 1003
    xb = torch.randn((m, k), device=card, generator=g)
    xb = xb * torch.exp(torch.randn((m, 1), device=card, generator=g) * 2)
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
            assert ops.launches["segment_agg"] > 0 and ops.launches["rans_decode"] > 0
    assert blobs[0] == blobs[1]
    assert answers[0] == answers[1]
    for sid in range(4):
        got = P.decode_series(blobs[0], sid, 0.0, device=card).cpu().numpy()
        assert np.array_equal(got, R.decode_series(blobs[0], sid, 0.0))
