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
        assert np.array_equal(pt.t0s.numpy(), rt.t0s) and np.array_equal(pt.ends.numpy(), rt.ends())
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
                           thetas=torch.from_numpy(thetas), slopes=torch.from_numpy(slopes),
                           ends=torch.from_numpy(t0s + lens))
    for t0, t1 in ((0, 4), (0, 2), (1, 4), (1, 3)):
        want, got = RA.base_aggregate(ref, t0, t1), PA.base_aggregate(port, t0, t1)
        assert np.signbit([got.vmin, got.vmax]).tolist() == \
            np.signbit([want.vmin, want.vmax]).tolist(), (t0, t1)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
