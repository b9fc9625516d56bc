"""Parity of the port's Alg. 2-3 stages with the reference, on the CPU.

* ``fluctuation_table``: exact against the numpy function.
* the plain cone scan in float64, compacted, row by row: every ``Segment``
  field exactly equal to ``repro.core.semantics.extract_semantics``;
* the plain cone scan in float32 against the TPU kernel's oracle
  ``repro.kernels.ref.cone_scan_ref``: breaks and origins exactly, spans
  within a stated bound (the two group the candidate slopes differently),
  with the oracle's +-3.4e38 span sentinels read as +-inf.
"""
import math

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core.phases as ref_phases
import repro.core.semantics as ref_sem
from repro.core.types import ShrinkConfig as RefConfig
from repro.kernels.ref import cone_scan_ref

from repro_torch.core import phases, semantics
from repro_torch.core.types import ShrinkConfig
from repro_torch.kernels import cone_scan as cs_mod
from repro_torch.kernels import ops


def _walk(seed: int, s: int, t: int, scale: float = 0.1, decimals: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * scale, decimals)


def _configs(v: np.ndarray, frac: float, lam: float):
    fields = dict(eps_b=frac * float(v.max() - v.min()), lam=lam)
    return RefConfig(**fields), ShrinkConfig(**fields)


CASES = {
    "walk_small_window": (0, 6, 1500, 0.05, 1e-5),
    "walk_wide_window": (1, 4, 2048, 0.05, 2e-3),  # L > 32: blocked van Herk
    "walk_window_covers_row": (2, 3, 300, 0.1, 1.0),  # L >= T
    "tight_eps": (3, 5, 1000, 0.005, 1e-5),  # many short segments
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fluctuation_table_exact(name):
    seed, s, t, frac, lam = CASES[name]
    v = _walk(seed, s, t)
    rc, pc = _configs(v, frac, lam)
    dg = v.max(axis=1) - v.min(axis=1)
    lv_r, eps_r = ref_phases.fluctuation_table(v, dg, rc)
    lv_p, eps_p = phases.fluctuation_table(torch.as_tensor(v), torch.as_tensor(dg), pc)
    np.testing.assert_array_equal(lv_p.numpy(), lv_r)
    np.testing.assert_array_equal(eps_p.numpy(), eps_r)


def test_fluctuation_table_n_hint_sets_window():
    v = _walk(7, 2, 400)
    rc, pc = _configs(v, 0.05, 1e-3)
    dg = v.max(axis=1) - v.min(axis=1)
    # the reference scan derives L from n_hint; the table must use the same
    _, eps_p = phases.fluctuation_table(torch.as_tensor(v), torch.as_tensor(dg), pc, n_hint=400_000)
    w = max(ref_phases.default_interval_length(400_000, rc), 2)
    assert w > 32
    for j in (0, 17, 399):
        level, eps = ref_phases.divide(v[0], j, w, float(dg[0]), rc)[1:]
        assert eps_p[0, j].item() == eps


def _segments_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.theta, a.level, a.t0, a.length) == (b.theta, b.level, b.t0, b.length)
        assert a.psi_lo == b.psi_lo and a.psi_hi == b.psi_hi
        assert math.copysign(1, a.psi_lo) == math.copysign(1, b.psi_lo)


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_scan_segments_equal_extract_semantics(name):
    seed, s, t, frac, lam = CASES[name]
    v = _walk(seed, s, t)
    rc, pc = _configs(v, frac, lam)
    got = semantics.extract_semantics_batch(torch.as_tensor(v), pc)
    for i in range(s):
        _segments_equal(got[i], ref_sem.extract_semantics(v[i], rc))


def test_plain_scan_compacted_by_hand_matches_reference():
    """The plain f64 scan + compact_segments, read row by row as the codec
    reads it, against the reference segments (no codec code in between)."""
    v = _walk(11, 5, 900)
    rc, pc = _configs(v, 0.02, 1e-5)
    x = torch.as_tensor(v)
    lv, eps = phases.fluctuation_table(x, x.amax(1) - x.amin(1), pc)
    scan = cs_mod.cone_scan_plain(x.T.contiguous(), eps.T.contiguous())
    counts, t0s, thetas, lo, hi = ops.compact_segments(*scan)
    for a in range(v.shape[0]):
        want = ref_sem.extract_semantics(v[a], rc)
        c = int(counts[a])
        assert c == len(want)
        starts = t0s[:c, a].tolist()
        assert starts == [sg.t0 for sg in want]
        assert thetas[:c, a].tolist() == [sg.theta for sg in want]
        assert lo[:c, a].tolist() == [sg.psi_lo for sg in want]
        assert hi[:c, a].tolist() == [sg.psi_hi for sg in want]
        assert lv[a, starts].tolist() == [sg.level for sg in want]


def test_extract_semantics_pinned_range_and_n_hint():
    v = _walk(5, 1, 700)[0]
    rc, pc = _configs(v, 0.05, 1e-3)
    vr = (float(v.min()) - 3.0, float(v.max()) + 1.0)
    want = ref_sem.extract_semantics(v, rc, value_range=vr, n_hint=50_000)
    got = semantics.extract_semantics(torch.as_tensor(v), pc, value_range=vr, n_hint=50_000)
    _segments_equal(got, want)
    assert semantics.extract_semantics(torch.zeros(0, dtype=torch.float64), pc) == []
    assert semantics.global_range(torch.as_tensor(v)) == ref_sem.global_range(v)


@pytest.mark.parametrize("ragged", [False, True])
def test_plain_scan_float32_matches_tpu_oracle(ragged):
    """The port groups a candidate slope as the host scan does,
    (v + (eps - theta)) / dt; the oracle as the TPU kernel did,
    ((v + eps) - theta) / dt.  Each numerator takes two roundings of at most
    half an ulp of the lane's operand scale M = max|x| + max eps + max|theta|,
    and each division half an ulp of its result, so a span may differ by
    2 ulp(M) + ulp(span).  On this data the difference never flips a
    comparison: breaks and origins agree exactly."""
    v = _walk(3, 8, 640).astype(np.float32)
    rc, pc = _configs(v.astype(np.float64), 0.02, 1e-5)
    _, eps = ref_phases.fluctuation_table(
        v.astype(np.float64), v.max(axis=1) - v.min(axis=1), rc
    )
    x = np.ascontiguousarray(v.T)
    e = np.ascontiguousarray(eps.T.astype(np.float32))
    lengths = np.array([640, 1, 2, 300, 639, 640, 17, 5], dtype=np.int32) if ragged else None
    want = [np.asarray(a) for a in cone_scan_ref(x, e, lengths=lengths)]
    got = cs_mod.cone_scan_plain(
        torch.as_tensor(x), torch.as_tensor(e),
        None if lengths is None else torch.as_tensor(lengths),
    )
    got = [g.numpy() for g in got]
    np.testing.assert_array_equal(got[0], want[0])  # breaks
    np.testing.assert_array_equal(got[1], want[1])  # thetas
    scale = np.abs(x).max(axis=0) + e.max(axis=0) + np.abs(got[1]).max(axis=0)
    for g, w in zip(got[2:], want[2:]):  # spans: sentinel +-3.4e38 == +-inf
        w = np.where(np.abs(w) >= 1e38, np.sign(w) * np.inf, w).reshape(g.shape)
        finite = np.isfinite(w)
        np.testing.assert_array_equal(g[~finite], w[~finite])
        w0 = np.where(finite, w, 0).astype(np.float32)
        bound = 2 * np.spacing(scale.astype(np.float32)) + np.spacing(np.abs(w0))
        diff = np.abs(np.where(finite, g, 0).astype(np.float64) - w0)
        assert (diff <= np.broadcast_to(bound, g.shape)).all()


def test_wrapper_takes_plain_version_on_cpu():
    v = torch.as_tensor(_walk(9, 2, 64)).T.contiguous()
    eps = torch.full_like(v, 0.3)
    before = dict(ops.launches)
    a = ops.cone_scan(v, eps)
    b = cs_mod.cone_scan_plain(v, eps)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert dict(ops.launches) == before  # no kernel launched on the CPU
