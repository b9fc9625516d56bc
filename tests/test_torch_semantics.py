"""Parity of the port's Alg. 2-3 stages with the reference, on the CPU.

* ``fluctuation_table``: exact against the numpy function.
* the plain cone scan in float64, compacted, row by row: every ``Segment``
  field exactly equal to ``repro.core.semantics.extract_semantics``;
* the plain cone scan in float32 against the TPU kernel's oracle
  ``repro.kernels.ref.cone_scan_ref``: breaks and origins exactly, spans
  within a stated bound (the two group the candidate slopes differently),
  with the oracle's +-3.4e38 span sentinels read as +-inf;
* the same on inputs where the card's window scan is hardest (breaks at
  every step, at window and lane-run edges, runs of equal candidates,
  lengths 0, 1 and T): small integers and halves, so both groupings are
  exact and every output must be equal.
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


def _hard_cases(t_len: int, s: int, seed: int = 0):
    """x, eps [T, S] and lengths [S] for the window scan's hard spots, in
    small integers and halves (exact in float32 under either grouping of
    the candidate slopes).  Columns: 0 breaks at every step (eps = -1
    crosses every pair of candidates); 1, 2 and 3 jump at the last and
    first steps of windows of ``WINDOW`` and at lane-run edges; 4 and 5
    give cand_hi == 3 and cand_lo == 3 at every step; 6 breaks every
    second step; 7, 8 and 9 have lengths 0, 1 and min(T, 300), 9 breaking
    at every step up to it; the rest are integer walks."""
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
    return x, e, ln


@pytest.mark.parametrize("t_len,s", [(1, 13), (100, 13), (700, 13), (512, 10)])
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_scan_hard_cases_match_tpu_oracle(t_len, s, ragged):
    """Every output of the plain scan equals the oracle's (sentinels read as
    +-inf) where the card's kernel is hardest: T = 1, T < WINDOW, T no
    multiple of it and a multiple of it; S no multiple of a block's 4 or 8
    series."""
    x, e, ln = _hard_cases(t_len, s)
    x, e = x.astype(np.float32), e.astype(np.float32)
    lengths = ln if ragged else None
    want = [np.asarray(a) for a in cone_scan_ref(x, e, lengths=lengths)]
    got = cs_mod.cone_scan_plain(
        torch.as_tensor(x), torch.as_tensor(e),
        None if lengths is None else torch.as_tensor(lengths),
    )
    got = [g.numpy() for g in got]
    assert got[0][:, 0].sum() == t_len  # column 0 breaks at every step
    if t_len > 2 * cs_mod.WINDOW:
        assert got[0][[cs_mod.WINDOW - 1, 2 * cs_mod.WINDOW - 1], 1].all()
        assert got[0][[cs_mod.WINDOW, 2 * cs_mod.WINDOW], 2].all()
    for g, w in zip(got, want):
        w = w.reshape(g.shape)
        if g.dtype.kind == "f":
            w = np.where(np.abs(w) >= 1e38, np.copysign(np.inf, w), w).astype(g.dtype)
        np.testing.assert_array_equal(g, w)


def test_wrapper_takes_plain_version_on_cpu():
    v = torch.as_tensor(_walk(9, 2, 64)).T.contiguous()
    eps = torch.full_like(v, 0.3)
    before = dict(ops.launches)
    a = ops.cone_scan(v, eps)
    b = cs_mod.cone_scan_plain(v, eps)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert dict(ops.launches) == before  # no kernel launched on the CPU
