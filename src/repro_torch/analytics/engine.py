"""Single-archive compressed-domain query engine, counterpart of
``repro.analytics.engine``.

``SeriesAnalytics`` answers queries over one :class:`CompressedSeries`
without reconstructing it:

* the **segment path** evaluates the closed-form per-segment algebra
  (``core.segment_algebra``: the ``segment_agg`` kernel and torch ops on
  the card) over the knowledge base, with zero entropy work, and widens
  the result by the base's practical error bound;
* the **dense path** decodes the cheapest pyramid layer prefix meeting
  the requested ``eps`` (a cached :class:`ProgressiveDecoder` on the
  card) and widens by that tier's guarantee;
* ``count_where`` runs the **refine loop**: classify every sample's
  interval against the predicate on the card, descend one pyramid layer
  at a time, and re-examine only the samples still straddling.

Every answer is an :class:`AggregateAnswer` interval ``[lo, hi]`` that
contains the decode-then-numpy truth, equal to the reference's answer:
reductions over dense slices copy the slice (at most a few frames of
float64) to the host and reduce it with numpy, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.segment_algebra import (
    SegmentTable,
    base_aggregate,
    base_aggregate_with_m2,
    count_cmp,
    segment_table,
)
from ..core.shrink import ProgressiveDecoder
from ..core.types import CompressedSeries

__all__ = [
    "AGG_OPS",
    "CMP_OPS",
    "AggregateAnswer",
    "SeriesAnalytics",
    "classify",
    "point_margin",
    "rank_similar",
    "rank_topk",
    "refine_count",
    "resolve_or_finest",
    "segment_records",
]

AGG_OPS = ("min", "max", "sum", "mean", "count", "stddev")
CMP_OPS = ("gt", "ge", "lt", "le")

_EPS64 = float(np.finfo(np.float64).eps)


def _fp_slack(scale: float) -> float:
    """Float allowance per point: covers the pyramid guarantee's tested ulp
    slack plus closed-form-vs-dense summation rounding."""
    return 8.0 * _EPS64 * max(1.0, scale)


def point_margin(g: float, scale: float) -> float:
    """Per-point containment margin for a representation with guarantee
    ``g``: the tier's bound, its relative slack, and float rounding.  A
    guarantee of exactly 0.0 (lossless prefix / exact base) means the
    reconstruction IS the decimal-grid truth — no margin."""
    if g == 0.0:
        return 0.0
    return g * (1.0 + 1e-9) + _fp_slack(scale)


def resolve_or_finest(cs: CompressedSeries, eps: float) -> int:
    """Layer-prefix index serving ``eps``, falling back to the finest
    available tier when no tier qualifies — an analytics answer then
    simply stays as tight as the archive allows (the achieved guarantee
    is always reported, so the caller sees what it got)."""
    try:
        return cs.pyramid.resolve(eps, cs.eps_b_practical)
    except ValueError:
        return len(cs.pyramid.layers) - 1


@dataclasses.dataclass
class AggregateAnswer:
    """One interval answer: the truth is guaranteed to lie in [lo, hi].

    ``eps`` is the per-point guarantee of the representation that served
    the query (0.0 = exact); ``exact`` marks a collapsed interval served
    from an exact reconstruction.  ``source`` is ``"segments"`` (closed
    form, zero entropy work), ``"dense"`` (pyramid prefix), or
    ``"mixed"`` (multi-frame plans using both).  ``layers_paid`` counts
    entropy-decoded layers this query actually triggered;
    ``frames_touched``/``frames_skipped``/``frames_refined`` report the
    planner's work (trivially 1/0/0-or-1 for a single archive)."""

    op: str
    lo: float
    hi: float
    m: int
    eps: float
    exact: bool
    source: str
    layers_paid: int = 0
    frames_touched: int = 1
    frames_skipped: int = 0
    frames_refined: int = 0
    # True when corruption capped refinement short of the requested eps:
    # the interval is then wider than asked for but STILL contains the
    # truth (``eps`` reports the guarantee actually achieved).
    degraded: bool = False

    @property
    def achieved_eps(self) -> float:
        """The per-point guarantee actually served (alias of ``eps``; the
        name the degradation contract in docs/robustness.md uses)."""
        return self.eps

    @property
    def width(self) -> float:
        return self.hi - self.lo

    @property
    def midpoint(self) -> float:
        return 0.5 * (self.lo + self.hi)

    def contains(self, x: float) -> bool:
        return self.lo <= x <= self.hi


def _compose(op: str, m: int, est: float, e_pt: float, e_sum: float) -> tuple[float, float]:
    """[lo, hi] for an aggregate estimate ``est`` whose per-point error is
    bounded by ``e_pt`` (``e_sum`` = the summed-error bound for ``sum``)."""
    if op in ("min", "max", "mean", "stddev"):
        lo, hi = est - e_pt, est + e_pt
        if op == "stddev":
            lo = max(lo, 0.0)
        return lo, hi
    if op == "sum":
        return est - e_sum, est + e_sum
    raise ValueError(f"unknown aggregate op {op!r}")


def classify(op: str, lb: torch.Tensor, ub: torch.Tensor, value: float):
    """(definitely-satisfies, definitely-not) masks for per-point truth
    intervals [lb, ub] against ``pred <op> value``."""
    if op == "gt":
        return lb > value, ub <= value
    if op == "ge":
        return lb >= value, ub < value
    if op == "lt":
        return ub < value, lb >= value
    if op == "le":
        return ub <= value, lb > value
    raise ValueError(f"unknown comparison {op!r}: expected one of {CMP_OPS}")


def refine_count(
    dec: ProgressiveDecoder,
    a: int,
    b: int,
    op: str,
    value: float,
    scale: float,
    k_target: int,
) -> tuple[int, int, float, int]:
    """The refine loop over one frame's samples [a, b), on the decoder's
    device: classify each sample's interval against the predicate,
    descending one pyramid layer at a time and re-examining ONLY the
    still-straddling samples; stops as soon as none straddle (or the target
    tier is reached).  Returns (definite_in, straddling,
    achieved_guarantee, layers_paid)."""
    n_in = 0
    idx: torch.Tensor | None = None
    g = dec.cs.eps_b_practical
    paid0 = dec.layers_decoded
    for d in range(-1, k_target + 1):
        recon = dec.prefix(d)[a:b]
        g = dec.guarantee(d)
        gm = point_margin(g, scale)
        r = recon if idx is None else recon[idx]
        lb, ub = r - gm, r + gm
        in_m, out_m = classify(op, lb, ub, value)
        n_in += int(torch.count_nonzero(in_m))
        keep = ~(in_m | out_m)
        idx = torch.nonzero(keep).reshape(-1) if idx is None else idx[keep]
        if idx.numel() == 0:
            break
    return n_in, int(idx.numel()), g, dec.layers_decoded - paid0


def _host(t: torch.Tensor) -> np.ndarray:
    """A dense slice on the host, where numpy reduces it as the reference
    does (pairwise sums, numpy's sign of a zero extreme)."""
    return t.cpu().numpy()


class SeriesAnalytics:
    """Compressed-domain queries over one :class:`CompressedSeries`, on
    the device of ``decoder`` (else ``device``, default the card).

    ``eps`` on every query is the per-point resolution the answer must be
    computed at: ``None`` = whatever the base alone guarantees (zero
    entropy work), ``0.0`` = exact.  The engine serves it from the
    cheapest sufficient representation and reports what it achieved.
    """

    def __init__(
        self,
        cs: CompressedSeries,
        decoder: ProgressiveDecoder | None = None,
        device: torch.device | str | None = None,
    ):
        self.cs = cs
        self.dec = decoder if decoder is not None else ProgressiveDecoder(cs, device)
        self.table: SegmentTable = segment_table(cs.base, self.dec.device)
        # conservative magnitude bound for float slack: the data's recorded
        # range, padded by the coarsest error the engine will ever serve
        self.scale = max(abs(cs.base.vmin), abs(cs.base.vmax)) + cs.eps_b_practical
        # per-range running intersection of the stddev prefix chain:
        # (deepest depth folded in, lo, hi) — repeated/refining stddev
        # queries pay one np.std per NEWLY decoded layer, not per call
        self._std_chain: dict[tuple[int, int], tuple[int, float, float]] = {}

    # ------------------------------------------------------------------ #
    @property
    def n(self) -> int:
        return self.cs.base.n

    def _span(self, t0: int, t1: int | None) -> tuple[int, int]:
        t1 = self.n if t1 is None else min(int(t1), self.n)
        t0 = max(int(t0), 0)
        return t0, t1

    def _resolve(self, eps: float) -> int:
        return resolve_or_finest(self.cs, eps)

    def _resolve_capped(self, eps: float) -> tuple[int, bool]:
        """Like ``_resolve`` but never descends into a quarantined layer:
        returns (prefix index, degraded?) where degraded means corruption
        forced a coarser prefix than ``eps`` asked for.  The interval math
        widens by the achieved guarantee, so a capped answer stays valid —
        just wider, and flagged."""
        k = resolve_or_finest(self.cs, eps)
        intact = self.dec.intact_depth()
        if k > intact:
            return intact, True
        return k, False

    def _use_segments(self, eps: float | None) -> bool:
        return eps is None or (eps > 0.0 and eps >= self.cs.eps_b_practical)

    # ------------------------------------------------------------------ #
    def aggregate(
        self, op: str, t0: int = 0, t1: int | None = None, eps: float | None = None
    ) -> AggregateAnswer:
        """Interval answer for ``op`` over samples [t0, t1)."""
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregate op {op!r}: expected one of {AGG_OPS}")
        t0, t1 = self._span(t0, t1)
        m = t1 - t0
        if op == "count":
            return AggregateAnswer(
                op=op, lo=float(max(m, 0)), hi=float(max(m, 0)), m=max(m, 0),
                eps=0.0, exact=True, source="segments",
            )
        if m <= 0:
            raise ValueError(f"empty sample range [{t0}, {t1})")

        if self._use_segments(eps):
            if op == "stddev":
                st, m2 = base_aggregate_with_m2(self.table, t0, t1)
                est = math.sqrt(max(m2, 0.0) / m)
            else:
                st = base_aggregate(self.table, t0, t1)
                est = {
                    "min": st.vmin, "max": st.vmax, "sum": st.total, "mean": st.mean,
                }[op]
            g = self.cs.eps_b_practical
            e_pt = point_margin(g, self.scale) + _fp_slack(self.scale)
            lo, hi = _compose(op, m, est, e_pt, m * e_pt)
            return AggregateAnswer(
                op=op, lo=lo, hi=hi, m=m, eps=g, exact=False, source="segments",
            )

        k, capped = self._resolve_capped(eps)
        paid0 = self.dec.layers_decoded
        sl = _host(self.dec.prefix(k)[t0:t1])
        paid = self.dec.layers_decoded - paid0
        g = self.dec.guarantee(k)
        exact = g == 0.0
        e_pt = point_margin(g, self.scale)
        if op == "stddev" and not exact:
            # the 0-clamp on stddev's lower bound breaks simple
            # per-tier width monotonicity (a finer tier's estimate can
            # escape the clamp); intersecting the intervals of every
            # materialized prefix — already decoded on the way to k —
            # restores "refining only tightens" by construction.  The
            # running intersection is cached per range, so only depths not
            # folded in yet pay an np.std pass (a repeat query pays none,
            # and an already-deeper chain simply serves its tighter bound)
            done, lo, hi = self._std_chain.get((t0, t1), (-2, -math.inf, math.inf))
            for d in range(done + 1, k + 1):
                if d < 0:  # the segment path's own interval, term for term
                    _, m2 = base_aggregate_with_m2(self.table, t0, t1)
                    est_d = math.sqrt(max(m2, 0.0) / m)
                    e_d = point_margin(self.cs.eps_b_practical, self.scale)
                    e_d += _fp_slack(self.scale)
                else:
                    est_d = float(np.std(_host(self.dec.prefix(d)[t0:t1])))
                    e_d = point_margin(self.dec.guarantee(d), self.scale)
                    e_d += _fp_slack(self.scale) if e_d else 0.0
                lo = max(lo, est_d - e_d)
                hi = min(hi, est_d + e_d)
            if k > done:
                self._std_chain[(t0, t1)] = (k, lo, hi)
            return AggregateAnswer(
                op=op, lo=max(lo, 0.0), hi=hi, m=m, eps=g, exact=False,
                source="dense", layers_paid=paid, frames_refined=1 if paid else 0,
                degraded=capped,
            )
        est = {
            "min": float(sl.min()),
            "max": float(sl.max()),
            "sum": float(np.sum(sl)),
            "mean": float(np.mean(sl)),
            "stddev": float(np.std(sl)),
        }[op]
        if exact:
            lo = hi = est
        else:
            # np.sum's own rounding (vs. the real-arithmetic Σ both bounds
            # refer to) rides on top of the per-point tier bound
            lo, hi = _compose(op, m, est, e_pt + _fp_slack(self.scale),
                              m * (e_pt + _fp_slack(self.scale)))
        return AggregateAnswer(
            op=op, lo=lo, hi=hi, m=m, eps=g, exact=exact, source="dense",
            layers_paid=paid, frames_refined=1 if paid else 0, degraded=capped,
        )

    # ------------------------------------------------------------------ #
    def count_where(
        self,
        op: str,
        value: float,
        t0: int = 0,
        t1: int | None = None,
        eps: float | None = None,
    ) -> AggregateAnswer:
        """Integer interval [definite, definite+straddling] for
        ``#{t in [t0, t1) : v_t <op> value}``.  Starts from the
        closed-form segment counts (zero decode); refines through pyramid
        layers only while some sample's interval still straddles the
        threshold and the requested ``eps`` asks for more."""
        if op not in CMP_OPS:
            raise ValueError(f"unknown comparison {op!r}: expected one of {CMP_OPS}")
        t0, t1 = self._span(t0, t1)
        m = t1 - t0
        if m <= 0:
            return AggregateAnswer(op=op, lo=0.0, hi=0.0, m=0, eps=0.0, exact=True,
                                   source="segments")
        g = self.cs.eps_b_practical
        margin = point_margin(g, self.scale)
        sgn = 1.0 if op in ("gt", "ge") else -1.0
        definite = count_cmp(self.table, t0, t1, op, value + sgn * margin)
        possible = count_cmp(self.table, t0, t1, op, value - sgn * margin)
        if definite == possible or self._use_segments(eps):
            return AggregateAnswer(
                op=op, lo=float(definite), hi=float(possible), m=m, eps=g,
                exact=definite == possible, source="segments",
            )
        k, capped = self._resolve_capped(eps)
        n_in, straddle, g, paid = refine_count(
            self.dec, t0, t1, op, value, self.scale, k
        )
        # both the segment interval and the refined interval contain the
        # truth; return their intersection (monotone by construction)
        lo = max(definite, n_in)
        hi = min(possible, n_in + straddle)
        return AggregateAnswer(
            op=op, lo=float(lo), hi=float(hi), m=m, eps=g, exact=lo == hi,
            source="dense", layers_paid=paid, frames_refined=1 if paid else 0,
            degraded=capped,
        )

    # ------------------------------------------------------------------ #
    def segments(self, t0: int = 0, t1: int | None = None) -> list[dict]:
        """The knowledge base's member segments overlapping [t0, t1) as
        plain records — the raw material of top-k queries."""
        t0, t1 = self._span(t0, t1)
        return segment_records(self.table, t0, t1)

    def topk_segments(
        self, k: int = 5, by: str = "length", t0: int = 0, t1: int | None = None
    ) -> list[dict]:
        """Top-k segments by ``length`` / ``slope`` / ``abs_slope`` /
        ``max`` / ``min`` — exact compressed-domain facts (for ``min`` the
        k *lowest-reaching* segments).  Deterministic tie-break by t0."""
        return rank_topk(self.segments(t0, t1), k, by)

    def similar_segments(
        self, slope: float, length: float, k: int = 5,
        t0: int = 0, t1: int | None = None,
    ) -> list[dict]:
        """k segments most similar to a query shape (slope, length) under
        a z-normalized L2 distance over the knowledge base — segment-level
        similarity search that never touches residuals."""
        return rank_similar(self.segments(t0, t1), slope, length, k)


# --------------------------------------------------------------------- #
# segment-record queries, shared with the multi-frame planner
# --------------------------------------------------------------------- #
def segment_records(
    table: SegmentTable, t0: int, t1: int, offset: int = 0
) -> list[dict]:
    """Member segments of ``table`` overlapping local samples [t0, t1) as
    plain records; ``offset`` shifts reported positions into container
    coordinates (a SHRKS frame's payload indexes from its own 0)."""
    idx, a, b = table.overlap(t0, t1)
    if not idx.numel():
        return []
    t0s, a, b = torch.stack([table.t0s[idx], a, b]).tolist()
    thetas, slopes = torch.stack([table.thetas[idx], table.slopes[idx]]).tolist()
    out = []
    for j in range(len(t0s)):
        theta = thetas[j]
        slope = slopes[j]
        va = theta + slope * float(a[j])
        vb = theta + slope * float(b[j] - 1)
        out.append({
            "t0": int(offset + t0s[j] + a[j]),
            "length": int(b[j] - a[j]),
            "theta": theta,
            "slope": slope,
            "vmin": min(va, vb),
            "vmax": max(va, vb),
        })
    return out


def rank_topk(recs: list[dict], k: int, by: str) -> list[dict]:
    key = {
        "length": lambda r: -r["length"],
        "slope": lambda r: -r["slope"],
        "abs_slope": lambda r: -abs(r["slope"]),
        "max": lambda r: -r["vmax"],
        "min": lambda r: r["vmin"],
    }.get(by)
    if key is None:
        raise ValueError(f"unknown top-k metric {by!r}")
    recs = sorted(recs, key=lambda r: (key(r), r["t0"]))
    return recs[: max(int(k), 0)]


def rank_similar(recs: list[dict], slope: float, length: float, k: int) -> list[dict]:
    if not recs:
        return []
    slopes = np.array([r["slope"] for r in recs])
    lens = np.array([r["length"] for r in recs], dtype=np.float64)
    s_sd = float(slopes.std()) or 1.0
    l_sd = float(lens.std()) or 1.0
    d = ((slopes - slope) / s_sd) ** 2 + ((lens - length) / l_sd) ** 2
    order = np.lexsort((np.array([r["t0"] for r in recs]), d))
    out = []
    for i in order[: max(int(k), 0)]:
        rec = dict(recs[int(i)])
        rec["distance"] = float(d[int(i)])
        out.append(rec)
    return out
