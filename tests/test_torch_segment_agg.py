"""The port's ``segment_agg`` (its plain torch version, which the wrapper
runs on CPU tensors) and ``core.segment_algebra`` against the reference,
on the CPU.

* float32: the JAX ``segment_agg`` (the Pallas kernel in interpret mode)
  and its oracle ``segment_agg_ref``, at rtol = atol = 1e-5, the
  reference's own tolerance (``tests/test_kernels.py``);
* float64: bit-identical to ``repro.core.segment_algebra``'s per-row
  terms, windows past 2^17 and signed-zero endpoints included;
* rows with b <= a give the identity in both dtypes;
* ``base_aggregate``, ``base_aggregate_with_m2``, ``base_central_m2`` and
  ``count_cmp`` equal to the reference's on seeded bases, a segment of
  300,000 samples included.  The CUDA kernel is held to the plain version
  in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import segment_algebra as RA
from repro.kernels import ref as kref
from repro.kernels.segment_agg import segment_agg_pallas

import repro_torch.core as P
from repro_torch.core import segment_algebra as PA
from repro_torch.kernels import ops
from repro_torch.kernels import segment_agg as SA


def _rows32(m: int):
    """The reference test's inputs (tests/test_kernels.py)."""
    rng = np.random.default_rng(11)
    theta = rng.standard_normal((m, 1)).astype(np.float32)
    slope = (rng.standard_normal((m, 1)) * 0.01).astype(np.float32)
    a = rng.integers(0, 64, (m, 1)).astype(np.float32)
    b = a + rng.integers(-8, 256, (m, 1)).astype(np.float32)
    return theta, slope, a, b


@pytest.mark.parametrize("m", [1, 8, 129, 1024])
def test_float32_matches_pallas_interpret_and_ref(m):
    rows = _rows32(m)
    before = dict(ops.launches)
    got = [t.numpy() for t in ops.segment_agg(*(torch.from_numpy(x) for x in rows))]
    assert ops.launches == before  # a CPU tensor takes the plain version
    for want in (segment_agg_pallas(*(jnp.asarray(x) for x in rows), interpret=True),
                 kref.segment_agg_ref(*(jnp.asarray(x) for x in rows))):
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (m, 1)
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def _reference_rows(theta, slope, a, b):
    """repro.core.segment_algebra.base_aggregate's per-row arrays."""
    m = (b - a).astype(np.float64)
    d1 = RA._s1(b) - RA._s1(a)
    d2 = RA._s2(b) - RA._s2(a)
    total = m * theta + slope * d1
    sumsq = m * theta * theta + 2.0 * theta * slope * d1 + slope * slope * d2
    va = theta + slope * a.astype(np.float64)
    vb = theta + slope * (b - 1).astype(np.float64)
    return total, sumsq, np.minimum(va, vb), np.maximum(va, vb)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64).view(np.int64)


def test_float64_bit_identical_to_segment_algebra_rows():
    rng = np.random.default_rng(5)
    m = 4096
    theta = np.round(rng.standard_normal(m) * 50, 3)
    slope = rng.standard_normal(m) * np.array([1e-1, 1e-4, 0.0, 3.0])[rng.integers(0, 4, m)]
    a = rng.integers(0, 5000, m)
    b = a + rng.integers(1, 4000, m)
    # windows past 2^17 samples, where a difference of cubes loses digits
    a[:64] = rng.integers(0, 1 << 20, 64)
    b[:64] = a[:64] + rng.integers(1 << 17, 1 << 21, 64)
    # signed-zero endpoints: -0.0 and +0.0 origins and slopes
    theta[64:72] = [-0.0, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0]
    slope[64:72] = [-0.0, -0.0, 0.0, 0.0, -1.5, 1.5, 2.0, -2.0]
    a[64:72], b[64:72] = 0, [1, 2, 1, 5, 1, 1, 3, 7]
    want = _reference_rows(theta, slope, a, b)
    cols = [torch.from_numpy(x.astype(np.float64).reshape(m, 1)) for x in (theta, slope, a, b)]
    got = ops.segment_agg(*cols)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g.numpy().reshape(-1)), _bits(w))
    # the Pallas body's difference of cubes is what the float64 route avoids
    d2_cubes = (b * (b - 1.0) * (2.0 * b - 1.0) - a * (a - 1.0) * (2.0 * a - 1.0)) / 6.0
    assert not np.array_equal(d2_cubes[:64], RA._s2(b[:64]) - RA._s2(a[:64]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_empty_windows_give_the_identity(dtype):
    a = torch.tensor([[5.0], [3.0], [0.0], [2.0]], dtype=dtype)
    b = torch.tensor([[5.0], [1.0], [4.0], [-1.0]], dtype=dtype)
    theta = torch.tensor([[1.0], [-2.0], [0.5], [7.0]], dtype=dtype)
    slope = torch.tensor([[0.1], [0.3], [-0.2], [1.0]], dtype=dtype)
    got = [t.numpy() for t in SA.segment_agg_plain(theta, slope, a, b)]
    want = [np.asarray(t) for t in kref.segment_agg_ref(
        *(jnp.asarray(x.numpy()) for x in (theta, slope, a, b)))]
    dead = np.array([True, True, False, True])
    for g, w, ident in zip(got, want, (0.0, 0.0, 3.4e38, -3.4e38)):
        assert np.all(g[dead, 0] == np.asarray(ident, g.dtype))
        if dtype == torch.float32:  # JAX runs the oracle in float32
            np.testing.assert_array_equal(g[dead], w[dead])
    for g, w in zip(got, want):  # the live row
        np.testing.assert_allclose(g[2], w[2], rtol=1e-6)


def _bases():
    rng = np.random.default_rng(8)
    walk = np.round(np.cumsum(rng.standard_normal(6000)) * 0.1, 4)
    ramp = np.round(np.arange(300_000) * 1e-3 + 2.0, 3)  # one segment of 300,000
    out = []
    for v, frac in ((walk, 0.05), (walk, 0.005), (ramp, 0.05)):
        codec = R.ShrinkCodec.from_fraction(v, frac=frac, backend="rans")
        blob = R.cs_to_bytes(codec.compress(v, [1e-2], decimals=None))
        out.append((v, R.cs_from_bytes(blob).base, P.cs_from_bytes(blob).base))
    return out


def test_segment_algebra_equals_the_reference():
    for v, rbase, pbase in _bases():
        rt, pt = RA.segment_table(rbase), PA.segment_table(pbase, "cpu")
        assert np.array_equal(pt.t0s.numpy(), rt.t0s) and np.array_equal(pt.ends().numpy(), rt.ends())
        n = v.size
        for t0, t1 in ((0, n), (7, 19), (n // 3, n - 5), (n - 1, n), (4, 4), (-9, n + 50)):
            assert dataclasses.astuple(PA.base_aggregate(pt, t0, t1)) == \
                dataclasses.astuple(RA.base_aggregate(rt, t0, t1))
            (ps, pm2), (rs, rm2) = PA.base_aggregate_with_m2(pt, t0, t1), \
                RA.base_aggregate_with_m2(rt, t0, t1)
            assert (dataclasses.astuple(ps), pm2) == (dataclasses.astuple(rs), rm2)
            for mu in (0.0, float(np.median(v))):
                assert PA.base_central_m2(pt, t0, t1, mu) == RA.base_central_m2(rt, t0, t1, mu)
            for op in ("gt", "ge", "lt", "le"):
                for c in (float(v.min()), float(np.quantile(v, 0.3)), float(v.max()) + 1.0):
                    assert PA.count_cmp(pt, t0, t1, op, c) == RA.count_cmp(rt, t0, t1, op, c)
            ri, ra, rb = rt.overlap(t0, t1)
            pi, pa, pb = pt.overlap(t0, t1)
            for g, w in ((pi, ri), (pa, ra), (pb, rb)):
                assert np.array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="unknown comparison"):
        PA.count_cmp(pt, 0, 5, "eq", 0.0)


def test_zero_extremes_take_numpys_sign():
    """Rows whose extremes are -0.0 and +0.0: the reduced min and max are
    numpy's (the port reduces the kernel's rows on the host)."""
    t0s = np.array([0, 1, 2, 3], dtype=np.int64)
    lens = np.ones(4, dtype=np.int64)
    thetas = np.array([-0.0, 0.0, 0.0, -0.0])
    slopes = np.array([-0.0, 0.0, 0.0, -0.0])
    ref = RA.SegmentTable(n=4, t0s=t0s, lens=lens, thetas=thetas, slopes=slopes)
    port = PA.SegmentTable(n=4, t0s=torch.from_numpy(t0s), lens=torch.from_numpy(lens),
                           thetas=torch.from_numpy(thetas), slopes=torch.from_numpy(slopes))
    for t0, t1 in ((0, 4), (0, 2), (1, 4), (1, 3)):
        want, got = RA.base_aggregate(ref, t0, t1), PA.base_aggregate(port, t0, t1)
        assert np.signbit([got.vmin, got.vmax]).tolist() == \
            np.signbit([want.vmin, want.vmax]).tolist(), (t0, t1)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ------------------------------------------------ the fused query step
def _table_pair(seed: int, k: int = 48):
    """A seeded segment table (reference, port): lengths from 1 to 8192
    (one-sample segments included), zero, signed-zero, negative and tiny
    slopes, and signed-zero origins."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([1, 1, 2, 3, 5, 8, 64, 700, 8192], k).astype(np.int64)
    lens[:3] = [1, 8192, 1]
    t0s = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    thetas = np.round(rng.standard_normal(k) * 50, 3)
    slopes = rng.choice([0.0, -0.0, 1e-12, -1e-9, 0.25, -3.5, 0.01, -0.02], k)
    thetas[3:7], slopes[3:7] = [-0.0, 0.0, -0.0, 0.0], [-0.0, 0.0, 0.0, -0.0]
    n = int(lens.sum())
    ref = RA.SegmentTable(n=n, t0s=t0s, lens=lens, thetas=thetas, slopes=slopes)
    port = PA.SegmentTable(n=n, t0s=torch.from_numpy(t0s), lens=torch.from_numpy(lens),
                           thetas=torch.from_numpy(thetas), slopes=torch.from_numpy(slopes))
    return ref, port


def _ranges(n: int, rng) -> list[tuple[int, int]]:
    """Whole, inner, one-sample, empty and out-of-frame ranges of [0, n)."""
    out = [(0, n), (-50, n + 50), (3, 4), (7, 7), (9, 2), (n, n + 9), (-9, 0), (-5, 3),
           (n - 1, n + 100)]
    for _ in range(12):
        a = int(rng.integers(-20, n))
        out.append((a, a + int(rng.integers(0, 20000))))
    return out


def _f64_bits(x: float) -> int:
    return int(np.float64(x).view(np.int64))


def _stats_bits(st) -> tuple:
    return (st.m, *(_f64_bits(x) for x in (st.total, st.sumsq, st.vmin, st.vmax)))


def _counting(monkeypatch) -> list:
    """Wrap ``ops.segment_query``; returns the list of its calls' modes."""
    calls, orig = [], ops.segment_query

    def counting(tables, desc, mode, *args, **kwargs):
        calls.append(mode)
        return orig(tables, desc, mode, *args, **kwargs)

    monkeypatch.setattr(ops, "segment_query", counting)
    return calls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_step_equals_reference_functions(seed, monkeypatch):
    """aggregate_parts, central_m2_parts and count_parts over many parts of
    three tables, one query step each, bit-identical to the reference's
    base_aggregate, base_central_m2 and count_cmp per part."""
    rng = np.random.default_rng(seed + 100)
    pairs = [_table_pair(seed * 3 + i) for i in range(3)]
    parts_r, parts_p = [], []
    for rt, pt in pairs:
        for t0, t1 in _ranges(rt.n, rng):
            parts_r.append((rt, t0, t1))
            parts_p.append((pt, t0, t1))
    calls = _counting(monkeypatch)
    got = PA.aggregate_parts(parts_p)
    want = [RA.base_aggregate(*p) for p in parts_r]
    assert [_stats_bits(s) for s in got] == [_stats_bits(s) for s in want]
    mus = [float(rng.normal() * 30) for _ in parts_p]
    got = PA.central_m2_parts(parts_p, mus)
    assert [_f64_bits(x) for x in got] == [
        _f64_bits(RA.base_central_m2(*p, mu)) for p, mu in zip(parts_r, mus)]
    # thresholds: random, and exactly equal to a prediction of the part
    preds = [RA.base_aggregate(*p) for p in parts_r]
    c1 = [s.vmin if s.m and i % 2 else float(rng.normal() * 40) for i, s in enumerate(preds)]
    c2 = [s.vmax if s.m and i % 3 else float(rng.normal() * 40) for i, s in enumerate(preds)]
    for op in ("gt", "ge", "lt", "le"):
        got = PA.count_parts(parts_p, op, c1, c2)
        assert got == [(RA.count_cmp(*p, op, a), RA.count_cmp(*p, op, b))
                       for p, a, b in zip(parts_r, c1, c2)]
    assert calls == ["aggregate", "central", "count", "count", "count", "count"]
    with pytest.raises(ValueError, match="unknown comparison"):
        PA.count_parts(parts_p, "eq", c1, c2)


def test_fused_counts_equal_the_dense_count():
    """The fixed-step bisection's counts equal a dense comparison of the
    float predictions, thresholds on a prediction included."""
    rt, pt = _table_pair(7)
    pred = np.concatenate([th + sl * np.arange(ln, dtype=np.float64)
                           for th, sl, ln in zip(rt.thetas, rt.slopes, rt.lens)])
    rng = np.random.default_rng(8)
    ranges = [(0, rt.n), (100, 9000), (8193, 8194), (5, 5)]
    cs = [float(pred[i]) for i in rng.integers(0, rt.n, 6)] + [0.0, -0.0, 1e9]
    for op, cmp in (("gt", np.greater), ("ge", np.greater_equal), ("lt", np.less),
                    ("le", np.less_equal)):
        for c in cs:
            got = PA.count_parts([(pt, a, b) for a, b in ranges], op, [c] * 4, [c] * 4)
            want = [int(cmp(pred[max(a, 0):b], c).sum()) for a, b in ranges]
            assert [g[0] for g in got] == want and [g[1] for g in got] == want


def test_reference_functions_are_one_step_each(monkeypatch):
    rt, pt = _table_pair(3)
    calls = _counting(monkeypatch)
    PA.base_aggregate(pt, 2, 9000)
    PA.base_central_m2(pt, 2, 9000, 1.5)
    PA.count_cmp(pt, 2, 9000, "le", 0.5)
    PA.base_aggregate_with_m2(pt, 2, 9000)
    assert calls == ["aggregate", "central", "count", "aggregate", "central"]
    stats, m2 = PA.base_aggregate_with_m2(pt, 2, 9000)
    want_stats, want_m2 = RA.base_aggregate_with_m2(rt, 2, 9000)
    assert (_stats_bits(stats), _f64_bits(m2)) == (_stats_bits(want_stats), _f64_bits(want_m2))
    assert PA.aggregate_parts([]) == [] and PA.count_parts([], "gt", [], []) == []


def test_plain_query_buffer_layout():
    """The step's buffer: a header (i0, i1, counts) a part, then the rows
    of each part from its row offset; ``query_parts`` reads it back."""
    rt, pt = _table_pair(4, k=8)
    tabs = [pt._packed, pt._packed]
    desc = torch.zeros((2, SA.DESC_WORDS), dtype=torch.int64)
    desc[0, 1:5] = torch.tensor([8, 0, 3, 0])
    desc[1, 1:5] = torch.tensor([8, 1, rt.n, 3])
    out = SA.segment_query(tabs, desc, "aggregate", "gt", 3 + 8)
    parts = SA.query_parts(out.numpy(), desc.numpy(), "aggregate", 11)
    for (t0, t1), (i0, i1, _, _, rows) in zip(((0, 3), (1, rt.n)), parts):
        idx, a, b = rt.overlap(t0, t1)
        assert (i0, i1) == (idx[0], idx[-1] + 1) and rows.shape == (4, idx.size)
        want = _reference_rows(rt.thetas[idx], rt.slopes[idx], a, b)
        assert all(np.array_equal(_bits(g), _bits(w)) for g, w in zip(rows, want))
    with pytest.raises(ValueError, match="mode"):
        SA.segment_query(tabs, desc, "sum", "gt", 11)
