"""Parity of the port's ragged batch path with the reference, on the CPU.

* ``compress_batch`` on a list of any lengths (empty and length-1 series
  included) and on ``[S, T]`` + ``lengths``, with ``max_buckets`` 1, 3 and
  the default: SHRK bytes identical to the reference's ``compress_batch``
  on the same input (not to the reference's per-series loop);
* ``fluctuation_table(..., lengths=)``: levels and eps_hat exact;
* the masked scan, ``base_predictions_ragged`` and the ragged pyramid
  quantizer: exact against the numpy functions;
* every series decodes losslessly, and at each tier within its eps.
"""
import dataclasses

import jax  # noqa: F401  (parity suites import both packages)
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import base as ref_base
from repro.core import phases as ref_phases
from repro.core import residuals as ref_res
from repro.core import semantics as ref_sem

import repro_torch.core as P
from repro_torch.core import base as port_base
from repro_torch.core import phases as port_phases
from repro_torch.core import residuals as port_res
from repro_torch.core import semantics as port_sem
from repro_torch.kernels import ops

TIERS = [1e-1, 1e-2, 1e-3, 0.0]
LENGTHS = [0, 1, 7, 63, 64, 65, 200, 1000, 2500, 0, 1, 2, 150, 640, 2048, 5, 333, 1999]


def _series(seed: int, lengths) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [np.round(np.cumsum(rng.standard_normal(n)) * 0.1, 4) for n in lengths]


def _codecs(arrs, frac=0.05, backend="best"):
    ref = R.ShrinkCodec.from_fraction(np.concatenate(arrs), frac=frac, backend=backend)
    port = P.ShrinkCodec(
        P.ShrinkConfig(**dataclasses.asdict(ref.config)), backend=backend, device="cpu"
    )
    return ref, port


def _padded(arrs):
    t = max(a.size for a in arrs)
    out = np.zeros((len(arrs), t))
    for i, a in enumerate(arrs):
        out[i, : a.size] = a
    return out


@pytest.mark.parametrize("max_buckets", [None, 1, 3])
@pytest.mark.parametrize("backend", ["best", "rans"])
def test_list_batch_bytes_identical(max_buckets, backend):
    arrs = _series(0, LENGTHS)
    ref, port = _codecs(arrs, backend=backend)
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(arrs, TIERS, 4, max_buckets=max_buckets)]
    ops.reset_launches()
    got = port.compress_batch(arrs, TIERS, 4, max_buckets=max_buckets)
    assert [P.cs_to_bytes(c) for c in got] == want
    assert ops.launches["cone_scan"] == 0  # the CPU tensors took the plain versions
    for cs, v in zip(got, arrs):
        assert cs.base.n == v.size
        np.testing.assert_array_equal(port.decompress_at(cs, 0.0).numpy(), v)


@pytest.mark.parametrize("max_buckets", [None, 1])
def test_lengths_batch_bytes_identical(max_buckets):
    arrs = _series(1, LENGTHS)
    ref, port = _codecs(arrs)
    pad = _padded(arrs)
    kw = dict(lengths=[a.size for a in arrs], max_buckets=max_buckets)
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(pad, TIERS, 4, **kw)]
    got = port.compress_batch(pad, TIERS, 4, **kw)
    assert [P.cs_to_bytes(c) for c in got] == want
    for cs, v in zip(got, arrs):
        dec = P.ProgressiveDecoder(P.cs_from_bytes(P.cs_to_bytes(cs)), "cpu")
        for k, eps in enumerate(TIERS):
            err = np.abs(dec.prefix(k).numpy() - v).max(initial=0.0)
            assert err <= eps * (1 + 1e-9) + 4 * np.finfo(float).eps * max(1.0, np.abs(v).max(initial=0))


def test_lossy_only_and_full_lengths():
    arrs = _series(2, [300, 17, 1, 900])
    ref, port = _codecs(arrs, frac=0.02)
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(arrs, [0.05, 1e-3])]
    assert [P.cs_to_bytes(c) for c in port.compress_batch(arrs, [0.05, 1e-3])] == want
    # lengths all equal to T take the rectangular path in both packages
    pad = _padded(arrs[:1] * 3)
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(pad, TIERS, 4, lengths=[300] * 3)]
    assert [P.cs_to_bytes(c) for c in port.compress_batch(pad, TIERS, 4, lengths=[300] * 3)] == want
    assert port.compress_batch([], TIERS, 4) == []


def test_bad_lengths_raise_as_reference():
    _, port = _codecs(_series(3, [10, 20]))
    with pytest.raises(ValueError, match="lengths"):
        port.compress_batch(np.zeros((2, 8)), [0.1], lengths=[8, -1])
    with pytest.raises(ValueError, match="lengths"):
        port.compress_batch(np.zeros((2, 8)), [0.1], lengths=[8])
    with pytest.raises(ValueError, match="lengths"):
        port.compress_batch([np.zeros(3)], [0.1], lengths=[3])


def test_fluctuation_table_lengths_exact():
    arrs = _series(4, [900, 1, 0, 64, 333, 899, 2])
    pad = _padded(arrs)
    ns = np.array([a.size for a in arrs])
    valid = np.arange(pad.shape[1])[None, :] < ns[:, None]
    dg = np.where(ns > 0, np.where(valid, pad, -np.inf).max(1) - np.where(valid, pad, np.inf).min(1), 0)
    for lam in (1e-5, 3e-2):
        cfg = dict(eps_b=0.3, lam=lam)
        lv_r, eps_r = ref_phases.fluctuation_table(pad, dg, R.ShrinkConfig(**cfg), lengths=ns)
        lv_p, eps_p = port_phases.fluctuation_table(
            torch.as_tensor(pad), torch.as_tensor(dg), P.ShrinkConfig(**cfg), lengths=ns
        )
        np.testing.assert_array_equal(lv_p.numpy(), lv_r)
        np.testing.assert_array_equal(eps_p.numpy(), eps_r)


def test_masked_scan_base_and_quantizer_exact():
    arrs = _series(5, [1200, 1, 513, 64, 9, 1199])
    pad = _padded(arrs)
    ns = np.array([a.size for a in arrs])
    cfg_r = R.ShrinkConfig(eps_b=0.4)
    cfg_p = P.ShrinkConfig(eps_b=0.4)
    want = ref_sem.extract_semantics_batch(pad, cfg_r, lengths=ns)
    got = port_sem.extract_semantics_batch(torch.as_tensor(pad), cfg_p, lengths=ns)
    assert [[dataclasses.astuple(s) for s in row] for row in got] == [
        [dataclasses.astuple(s) for s in row] for row in want
    ]
    # each row equals the scan of its unpadded slice
    assert [[dataclasses.astuple(s) for s in ref_sem.extract_semantics(a, cfg_r)] for a in arrs] == [
        [dataclasses.astuple(s) for s in row] for row in got
    ]
    bases_r = [
        ref_base.construct_base(want[i], int(ns[i]), float(a.min()), float(a.max()), cfg_r)
        for i, a in enumerate(arrs)
    ]
    bases_p = [
        port_base.construct_base(got[i], int(ns[i]), float(a.min()), float(a.max()), cfg_p)
        for i, a in enumerate(arrs)
    ]
    pr = ref_base.base_predictions_ragged(bases_r, pad.shape[1])
    pp = port_base.base_predictions_ragged(bases_p, pad.shape[1], "cpu")
    np.testing.assert_array_equal(pp.numpy(), pr)
    tiers = ref_res.normalize_tiers(TIERS, 4)
    sr = ref_res.quantize_pyramid_batch(pad, pr, tiers, 4, lengths=ns)
    sp = port_res.quantize_pyramid_batch(torch.as_tensor(pad), pp, tiers, 4, lengths=ns)
    for row_r, row_p in zip(sr, sp):
        for a, b in zip(row_r, row_p):
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.eps_r, a.step, a.r_lo, a.mode) == (b.eps_r, b.step, b.r_lo, b.mode)
                np.testing.assert_array_equal(b.q.numpy(), a.q)


def test_signed_zero_extremes_bytes_identical():
    """Series whose min or max is a zero, with +0.0 and -0.0 both present:
    the sign numpy gives that zero (stored in the base and in a layer's
    r_lo) depends on its reduction order, and the port takes numpy's in
    each of the reference's paths (single, rectangular, ragged)."""
    rng = np.random.default_rng(6)
    sign = np.where(rng.random(40) < 0.5, -1.0, 1.0)
    mixed = np.round(np.abs(rng.standard_normal(40)) * (rng.random(40) < 0.5), 1) * sign
    series = [np.zeros(9), np.array([0.0, -0.0]), np.array([-0.0, 0.0, 0.5]),
              np.array([0.5, -0.0]), np.array([-0.0] * 5 + [0.0] * 3), np.array([0.0, -0.0, -0.5]),
              mixed]
    ref = R.ShrinkCodec(R.ShrinkConfig(eps_b=1.0))
    port = P.ShrinkCodec(P.ShrinkConfig(eps_b=1.0), device="cpu")
    for tiers, dec in (([0.1], None), ([0.3, 0.0], 1)):
        want = [R.cs_to_bytes(c) for c in ref.compress_batch(series, tiers, dec, max_buckets=1)]
        got = port.compress_batch(series, tiers, dec, max_buckets=1)
        assert [P.cs_to_bytes(c) for c in got] == want
        for v in series:
            assert P.cs_to_bytes(port.compress(v, tiers, dec)) == R.cs_to_bytes(
                ref.compress(v, tiers, dec))
            rect = np.stack([v, v[::-1]])
            assert [P.cs_to_bytes(c) for c in port.compress_batch(rect, tiers, dec)] == [
                R.cs_to_bytes(c) for c in ref.compress_batch(rect, tiers, dec)]


@pytest.mark.parametrize("layout", ["rect", "lengths", "list"])
def test_zero_extreme_rows_among_others_bytes_identical(layout):
    """Non-negative feeds (counts, rainfall) have a zero minimum in most
    rows: in a batch where only some rows do, each row's zero still takes
    numpy's sign, in the base and in every layer's r_lo."""
    rng = np.random.default_rng(11)
    t = 400
    rows = np.round(np.cumsum(rng.standard_normal((6, t)), axis=1) * 0.1, 3) + 50.0
    dry = np.tile([-0.0] * 5 + [0.0] * 3, t // 8)  # zeros of both signs
    for r in (1, 4):  # rainfall-like: mostly zero, a few showers
        rain = dry.copy()
        rain[rng.choice(t, 60, replace=False)] = np.round(np.abs(rng.standard_normal(60)) * 2, 3) + 0.001
        rows[r] = rain
    rows[2, ::7] = 0.0  # a zero minimum below an otherwise positive walk
    ns = [t, 350, t, 200, 391, t]
    if layout == "rect":
        args, kw = (rows,), {}
    elif layout == "lengths":
        args, kw = (rows,), {"lengths": ns}
    else:
        args, kw = ([rows[i, : ns[i]] for i in range(6)],), {}
    ref = R.ShrinkCodec(R.ShrinkConfig(eps_b=0.5))
    port = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.5), device="cpu")
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(*args, TIERS, 3, **kw)]
    got = port.compress_batch(*args, TIERS, 3, **kw)
    assert [P.cs_to_bytes(c) for c in got] == want
