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
(the card by default), packed once into the buffer the ``segment_query``
kernel reads (``kernels.ops.segment_query``).  A query step over any number
of tables (the frames a query touches) is one launch: the overlap search,
then the per-segment sum, sum of squares and extrema, or the central terms
about a mean, or the threshold counts (a fixed-step bisection a row).  On
the card the step's descriptors go up in one asynchronous copy and its
output comes back in one copy and one synchronization.  The reductions
over segment rows are numpy's, on the host, so every answer is
bit-identical to the reference's (pairwise summation, and numpy's sign of
a zero extreme); integer counts are summed on the device, exact in any
order.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import ops
from ..kernels import segment_agg as SA
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
    "aggregate_parts",
    "central_m2_parts",
    "count_parts",
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
    built once per base or frame and reused by every query on it.  Built,
    it also holds its segment ends and the packed copy the query kernel
    reads (:func:`kernels.segment_agg.pack_table`)."""

    n: int
    t0s: torch.Tensor  # int64 [k] segment start indices
    lens: torch.Tensor  # int64 [k]
    thetas: torch.Tensor  # float64 [k]
    slopes: torch.Tensor  # float64 [k]
    _ends: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    _packed: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_ends", self.t0s + self.lens)
        object.__setattr__(self, "_packed",
                           SA.pack_table(self.t0s, self.lens, self.thetas, self.slopes))

    @property
    def k(self) -> int:
        return int(self.t0s.numel())

    def ends(self) -> torch.Tensor:
        return self._ends

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
            torch.searchsorted(self._ends, t0, right=True),
            torch.searchsorted(self.t0s, t1),
        ]).tolist()
        idx = torch.arange(i0, i1, dtype=torch.int64, device=self.t0s.device)
        starts = self.t0s[i0:i1]
        a = torch.clamp(t0 - starts, min=0)
        b = torch.minimum(t1 - starts, self.lens[i0:i1])
        return idx, a, b


def segment_table(base: Base, device: torch.device | str | None = None) -> SegmentTable:
    """The :class:`SegmentTable` of ``base`` on ``device`` (default the card),
    its four columns sent up as one buffer: one asynchronous copy from
    pinned memory on the card, where a copy a column would synchronize."""
    dev = resolve_device(device)
    t0s, lens, thetas, slopes = _flat_segments(base)
    host = np.stack([t0s.astype(np.int64), lens.astype(np.int64),
                     thetas.astype(np.float64).view(np.int64),
                     slopes.astype(np.float64).view(np.int64)])
    if dev.type == "cuda":
        pinned = torch.empty(host.shape, dtype=torch.int64, pin_memory=True)
        pinned.numpy()[:] = host
        cols = pinned.to(dev, non_blocking=True)
    else:
        cols = torch.from_numpy(host)
    return SegmentTable(n=base.n, t0s=cols[0], lens=cols[1], thetas=cols[2].view(torch.float64),
                        slopes=cols[3].view(torch.float64))


# ------------------------------------------------------------- query steps
def _bits(x: float) -> int:
    return int(np.float64(x).view(np.int64))


def _step(parts, mode: str, f1=None, f2=None, op: str = "gt"):
    """One ``segment_query`` launch over ``parts``, each a (table, t0, t1);
    returns one :func:`kernels.segment_agg.query_parts` tuple a part and
    the length of each part's clamped range.  On the card: the descriptors
    up in one asynchronous copy from pinned memory, the output back in one
    copy into pinned memory and one synchronization."""
    if not parts:
        return [], []
    dev = parts[0][0].t0s.device
    desc = np.zeros((len(parts), SA.DESC_WORDS), dtype=np.int64)
    spans, off = [], 0
    for p, (tab, t0, t1) in enumerate(parts):
        t0, t1 = max(int(t0), 0), min(int(t1), tab.n)
        if t1 <= t0 or not tab.k:
            t0 = t1 = 0
        spans.append(t1 - t0)
        desc[p] = (tab._packed.data_ptr(), tab.k, t0, t1, off,
                   _bits(f1[p]) if f1 is not None else 0,
                   _bits(f2[p]) if f2 is not None else 0, 0)
        off += min(tab.k, t1 - t0)
    tables = [tab._packed for tab, _, _ in parts]
    if dev.type == "cuda":
        host = torch.empty(desc.shape, dtype=torch.int64, pin_memory=True)
        host.numpy()[:] = desc
        out = ops.segment_query(tables, host.to(dev, non_blocking=True), mode, op, off)
        back = torch.empty(out.shape, dtype=torch.int64, pin_memory=True)
        back.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    else:
        back = ops.segment_query(tables, torch.from_numpy(desc), mode, op, off)
    return SA.query_parts(back.numpy().copy(), desc, mode, off), spans


def aggregate_parts(parts) -> list[BaseStats]:
    """:func:`base_aggregate` of every part, in one query step."""
    out = []
    for (i0, i1, _, _, rows), m in zip(*_step(parts, "aggregate")):
        if i1 == i0:
            out.append(_EMPTY)
            continue
        total, sumsq, vmin, vmax = rows
        out.append(BaseStats(m=m, total=float(total.sum()), sumsq=float(sumsq.sum()),
                             vmin=float(vmin.min()), vmax=float(vmax.max())))
    return out


def central_m2_parts(parts, mus) -> list[float]:
    """:func:`base_central_m2` of every part about its own ``mus[p]``, in
    one query step."""
    return [float(rows[0].sum()) if i1 > i0 else 0.0
            for (i0, i1, _, _, rows) in _step(parts, "central", f1=mus)[0]]


def count_parts(parts, op: str, c1s, c2s) -> list[tuple[int, int]]:
    """``(count_cmp(.., op, c1s[p]), count_cmp(.., op, c2s[p]))`` of every
    part, in one query step."""
    if op not in _CMPS:
        raise ValueError(f"unknown comparison {op!r}: expected one of {_CMPS}")
    return [(c1, c2) for (_, _, c1, c2, _) in _step(parts, "count", c1s, c2s, op)[0]]


def base_aggregate(table: SegmentTable, t0: int, t1: int) -> BaseStats:
    """Exact (up to float rounding) aggregates of the base approximation
    over samples [t0, t1), in O(#segments touched)."""
    return aggregate_parts([(table, t0, t1)])[0]


def base_aggregate_with_m2(
    table: SegmentTable, t0: int, t1: int
) -> tuple[BaseStats, float]:
    """:func:`base_aggregate` and the central second moment about the
    range's own mean: two query steps (the mean first)."""
    stats = base_aggregate(table, t0, t1)
    if not stats.m:
        return _EMPTY, 0.0
    return stats, base_central_m2(table, t0, t1, stats.total / stats.m)


def base_central_m2(table: SegmentTable, t0: int, t1: int, mu: float) -> float:
    """Σ (pred − mu)² over samples [t0, t1), closed form per segment (the
    deviation around each segment's own window mean, then a shift to
    ``mu``), so stddev bounds stay tight even when |values| ≫ stddev."""
    return central_m2_parts([(table, t0, t1)], [mu])[0]


def count_cmp(table: SegmentTable, t0: int, t1: int, op: str, c: float) -> int:
    """Exact count of samples in [t0, t1) whose base approximation
    satisfies ``pred <op> c``, equal to the dense count over the same
    float predictions."""
    return count_parts([(table, t0, t1)], op, [c], [c])[0][0]
