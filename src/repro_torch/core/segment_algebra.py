"""Closed-form segment-domain aggregates over the SHRINK knowledge base,
counterpart of ``repro.core.segment_algebra``.

SHRINK's base is a piecewise-linear partition of the series, so sums,
extrema and threshold counts of the base approximation have closed forms
per segment: a query over [t0, t1) costs O(#segments touched) and never
touches the entropy-coded residuals.  For a segment with origin
``theta`` and slope ``s`` over local indices ``i in [a, b)``:

* ``sum   = m*theta + s * (S1(b) - S1(a))``            with ``S1(x) = x(x-1)/2``
* ``sumsq = m*theta^2 + 2 theta s (S1(b)-S1(a)) + s^2 (S2(b)-S2(a))``
  with ``S2(x) = x(x-1)(2x-1)/6``
* ``min/max`` at the endpoints (the segment is monotone), and
* ``count(pred cmp c)`` is an index-interval count, found by an integer
  bisection against the actual float predictions.

Where the work runs: the :class:`SegmentTable` lives on the base's device
(the card by default).  The overlap is a ``torch.searchsorted``, the
per-segment sum, sum of squares and extrema come from the ``segment_agg``
kernel (``kernels.ops.segment_agg``), and the second moments and the
threshold counts are torch ops.  The reductions over segment rows are
numpy's: the per-row arrays are copied to the host (one copy a query
step) and summed there, so every answer is bit-identical to the
reference's (pairwise summation, and numpy's sign of a zero extreme).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import ops
from ..kernels.segment_agg import _div
from .base import _flat_segments
from .device import resolve_device
from .types import Base

__all__ = [
    "BaseStats",
    "SegmentTable",
    "segment_table",
    "base_aggregate",
    "base_aggregate_with_m2",
    "base_central_m2",
    "count_cmp",
]

_CMPS = ("gt", "ge", "lt", "le")


@dataclasses.dataclass(frozen=True)
class BaseStats:
    """Exact aggregates of the base approximation over one sample range.

    ``m`` samples; ``total``/``sumsq`` are Σ pred / Σ pred²; ``vmin``/
    ``vmax`` the extrema (+inf/-inf for an empty range)."""

    m: int
    total: float
    sumsq: float
    vmin: float
    vmax: float

    @property
    def mean(self) -> float:
        return self.total / self.m if self.m else math.nan

    def std(self) -> float:
        """Population stddev of the base approximation (clamped at 0)."""
        if not self.m:
            return math.nan
        var = self.sumsq / self.m - (self.total / self.m) ** 2
        return math.sqrt(max(var, 0.0))


_EMPTY = BaseStats(m=0, total=0.0, sumsq=0.0, vmin=math.inf, vmax=-math.inf)


@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """The base's member segments as parallel device tensors sorted by t0
    (a partition of [0, n)): the queryable form of the knowledge base,
    built once per base or frame and reused by every query on it."""

    n: int
    t0s: torch.Tensor  # int64 [k] segment start indices
    lens: torch.Tensor  # int64 [k]
    thetas: torch.Tensor  # float64 [k]
    slopes: torch.Tensor  # float64 [k]
    ends: torch.Tensor  # int64 [k], t0s + lens

    @property
    def k(self) -> int:
        return int(self.t0s.numel())

    def overlap(self, t0: int, t1: int):
        """(segment indices, local start a[], local end b[]) of every
        segment intersecting [t0, t1); a/b are segment-local, b exclusive.
        Every segment is at least one sample long, so each row of the
        search's range has b > a."""
        t0, t1 = max(int(t0), 0), min(int(t1), self.n)
        if t1 <= t0 or not self.k:
            z = torch.zeros(0, dtype=torch.int64, device=self.t0s.device)
            return z, z, z
        i0, i1 = torch.stack([
            torch.searchsorted(self.ends, t0, right=True),
            torch.searchsorted(self.t0s, t1),
        ]).tolist()
        idx = torch.arange(i0, i1, dtype=torch.int64, device=self.t0s.device)
        starts = self.t0s[i0:i1]
        a = torch.clamp(t0 - starts, min=0)
        b = torch.minimum(t1 - starts, self.lens[i0:i1])
        return idx, a, b


def segment_table(base: Base, device: torch.device | str | None = None) -> SegmentTable:
    """The :class:`SegmentTable` of ``base`` on ``device`` (default the card)."""
    dev = resolve_device(device)
    t0s, lens, thetas, slopes = (torch.as_tensor(x, device=dev) for x in _flat_segments(base))
    return SegmentTable(n=base.n, t0s=t0s, lens=lens, thetas=thetas, slopes=slopes,
                        ends=t0s + lens)


def _rows(table: SegmentTable, idx, a, b) -> tuple[np.ndarray, ...]:
    """Per-segment (sum, sumsq, min, max, m) of the overlap rows from the
    ``segment_agg`` kernel, copied to the host in one transfer."""
    cols = [x.reshape(-1, 1) for x in (table.thetas[idx], table.slopes[idx], a.double(), b.double())]
    out = ops.segment_agg(*cols)
    return tuple(torch.stack([x.reshape(-1) for x in out] + [(b - a).double()]).cpu().numpy())


def base_aggregate(table: SegmentTable, t0: int, t1: int) -> BaseStats:
    """Exact (up to float rounding) aggregates of the base approximation
    over samples [t0, t1), in O(#segments touched)."""
    idx, a, b = table.overlap(t0, t1)
    if not idx.numel():
        return _EMPTY
    total, sumsq, vmin, vmax, m = _rows(table, idx, a, b)
    return BaseStats(
        m=int(m.sum()),
        total=float(total.sum()),
        sumsq=float(sumsq.sum()),
        vmin=float(vmin.min()),
        vmax=float(vmax.max()),
    )


def _central_terms(table: SegmentTable, idx, a, b, mu: float) -> torch.Tensor:
    """Per-segment Σ (pred - mu)² over the overlap rows: the exact
    within-segment part ``s² m (m² - 1) / 12`` plus the shift of the
    segment's window mean to ``mu``."""
    theta = table.thetas[idx]
    slope = table.slopes[idx]
    m = (b - a).double()
    ibar = _div((a + b - 1).double(), 2.0)
    seg_mean = theta + slope * ibar
    m2_within = _div(slope * slope * m * (m * m - 1.0), 12.0)
    dev = seg_mean - mu
    return m2_within + m * (dev * dev)


def base_aggregate_with_m2(
    table: SegmentTable, t0: int, t1: int
) -> tuple[BaseStats, float]:
    """:func:`base_aggregate` and the central second moment about the
    range's own mean, from one overlap search."""
    idx, a, b = table.overlap(t0, t1)
    if not idx.numel():
        return _EMPTY, 0.0
    total, sumsq, vmin, vmax, mrow = _rows(table, idx, a, b)
    m = int(mrow.sum())
    grand = float(total.sum())
    mu = grand / m
    m2 = float(_central_terms(table, idx, a, b, mu).cpu().numpy().sum())
    stats = BaseStats(
        m=m,
        total=grand,
        sumsq=float(sumsq.sum()),
        vmin=float(vmin.min()),
        vmax=float(vmax.max()),
    )
    return stats, m2


def base_central_m2(table: SegmentTable, t0: int, t1: int, mu: float) -> float:
    """Σ (pred − mu)² over samples [t0, t1), closed form per segment (the
    deviation around each segment's own window mean, then a shift to
    ``mu``), so stddev bounds stay tight even when |values| ≫ stddev."""
    idx, a, b = table.overlap(t0, t1)
    if not idx.numel():
        return 0.0
    return float(_central_terms(table, idx, a, b, mu).cpu().numpy().sum())


def _first_true(sat_fn, lo0: torch.Tensor, hi0: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Per row, the smallest i in [lo0, hi0) with ``sat_fn(i)`` True (hi0 =
    none), given that the predicate is a True-suffix over i on active
    rows: an exact integer bisection (one sync a step)."""
    hi = hi0
    lo = torch.where(active, lo0, hi0)
    while True:
        open_ = lo < hi
        if not bool(open_.any()):
            return lo
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        s = sat_fn(mid.double())
        hi = torch.where(open_ & s, mid, hi)
        lo = torch.where(open_ & ~s, mid + 1, lo)


def _count_upset(theta, slope, a, b, c: float, strict: bool) -> torch.Tensor:
    """Per-segment count of local i in [a, b) with ``theta + slope*i > c``
    (``>= c`` when not strict).  The prediction is monotone in i under
    rounding too, so the satisfied set is a half-line of indices and the
    bisection against the float predictions finds its boundary exactly."""
    m = (b - a).double()

    def sat(i: torch.Tensor) -> torch.Tensor:
        v = theta + slope * i
        return v > c if strict else v >= c

    v0 = theta > c if strict else theta >= c
    out = torch.where((slope == 0.0) & v0, m, 0.0)
    # nondecreasing prediction: the satisfied set is {i >= imin}
    pos = slope > 0.0
    imin = _first_true(sat, a, b, pos)
    out = torch.where(pos, (b - imin).double(), out)
    # nonincreasing: a True-prefix, which ends at the first unsatisfied i
    neg = slope < 0.0
    end = _first_true(lambda i: ~sat(i), a, b, neg)
    return torch.where(neg, (end - a).double(), out)


def count_cmp(table: SegmentTable, t0: int, t1: int, op: str, c: float) -> int:
    """Exact count of samples in [t0, t1) whose base approximation
    satisfies ``pred <op> c``, equal to the dense count over the same
    float predictions."""
    if op not in _CMPS:
        raise ValueError(f"unknown comparison {op!r}: expected one of {_CMPS}")
    idx, a, b = table.overlap(t0, t1)
    if not idx.numel():
        return 0
    theta = table.thetas[idx]
    slope = table.slopes[idx]
    m = (b - a).double()
    if op == "gt":
        cnt = _count_upset(theta, slope, a, b, c, strict=True)
    elif op == "ge":
        cnt = _count_upset(theta, slope, a, b, c, strict=False)
    elif op == "lt":  # pred < c  ==  m - (pred >= c)
        cnt = m - _count_upset(theta, slope, a, b, c, strict=False)
    else:  # "le":     pred <= c  ==  m - (pred > c)
        cnt = m - _count_upset(theta, slope, a, b, c, strict=True)
    return int(cnt.sum())
