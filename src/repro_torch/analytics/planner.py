"""Frame-skipping query planner over ``SHRKS`` containers, counterpart of
``repro.analytics.planner``.

``AnalyticsEngine`` answers the :class:`SeriesAnalytics` query surface
against a framed stream container, planning per frame:

* **sketch** — each touched frame's knowledge base is parsed once (no
  entropy work) into a :class:`SegmentTable` on the device plus its
  practical error bound, cached for the life of the engine;
* **skip** — frames whose sketch bounds cannot affect the answer are
  never decoded (min/max: a frame whose optimistic bound is worse than
  another's pessimistic one; predicates: a frame whose segment-domain
  count interval already collapsed);
* **refine** — the surviving frames descend their residual pyramids
  through the serving LRU's cached :class:`ProgressiveDecoder` prefixes
  (``RangeQueryBatcher.decoder``), so analytics and range queries share
  decoded layers.

The segment algebra runs on the batcher's device: each step of a query
(the extrema, the unrefined parts' sums, the central second moment, or
both thresholds of every part of a ``count_where``) is one
``segment_query`` launch over all the frames it touches, with one read-back.
A refined frame's dense slice is copied to the host once and reduced with
numpy, so every answer and every ``stats`` count equals the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.errors import CorruptFrameError
from ..core.segment_algebra import (
    SegmentTable,
    aggregate_parts,
    central_m2_parts,
    count_parts,
    segment_table,
)
from ..core.serialize import frame_payload
from ..core.shrink import cs_from_bytes
from ..serving.batching import RangeQueryBatcher
from .engine import (
    AGG_OPS,
    CMP_OPS,
    AggregateAnswer,
    _fp_slack,
    _host,
    point_margin,
    rank_similar,
    rank_topk,
    refine_count,
    resolve_or_finest,
    segment_records,
)

__all__ = ["AnalyticsEngine"]


@dataclasses.dataclass
class _FrameSketch:
    """Per-frame zero-decode synopsis: the parsed knowledge base and its
    guarantee — everything the planner needs before deciding to pay for
    residual layers."""

    meta: object
    table: SegmentTable
    eps_b: float
    scale: float


@dataclasses.dataclass
class _Part:
    """One frame's contribution to a planned aggregate."""

    sk: _FrameSketch
    a: int  # frame-local overlap [a, b)
    b: int
    m: int
    est: float = 0.0
    e_pt: float = 0.0  # per-point containment margin of this contribution
    dense: np.ndarray | None = None  # decoded slice when refined (host copy)
    exact: bool = False
    degraded: bool = False  # corruption capped this frame short of eps


class AnalyticsEngine:
    """Compressed-domain analytics over a ``SHRKS`` container.

    ``source`` is either the container bytes or an existing
    :class:`RangeQueryBatcher` — passing the serving batcher shares its
    frame-decoder LRU (and its device), so a dashboard mixing range
    decodes and aggregates pays each pyramid layer at most once.  Built
    from bytes, the engine makes its own batcher on ``device`` (default
    the card); ``kb_store`` is forwarded to it.
    """

    def __init__(
        self,
        source: bytes | RangeQueryBatcher,
        cache_frames: int = 32,
        degraded_ok: bool = False,
        kb_store=None,
        device: torch.device | str | None = None,
    ):
        if isinstance(source, RangeQueryBatcher):
            self.batcher = source  # inherits the batcher's degraded_ok and device
        else:
            self.batcher = RangeQueryBatcher(
                source,
                cache_frames=cache_frames,
                degraded_ok=degraded_ok,
                kb_store=kb_store,
                device=device,
            )
        self._sketches: dict[int, _FrameSketch] = {}
        self.stats = {
            "queries": 0,
            "frames_touched": 0,
            "frames_skipped": 0,
            "frames_refined": 0,
            "segment_frames": 0,
            "layers_paid": 0,
            "degraded": 0,
        }

    # ------------------------------------------------------------------ #
    @property
    def series_ids(self) -> list[int]:
        return self.batcher.series_ids

    def span(self, series_id: int) -> tuple[int, int]:
        return self.batcher.span(series_id)

    def _sketch(self, meta) -> _FrameSketch:
        sk = self._sketches.get(meta.offset)
        if sk is None:
            try:
                cs = cs_from_bytes(frame_payload(self.batcher.blob, meta))
            except CorruptFrameError:
                if not self.batcher.degraded_ok:
                    raise
                # a sketch only needs the base + eps_hat, which the SHRK
                # header CRC protects independently of the frame CRC: a
                # frame whose residual section is damaged still yields a
                # valid (coarse) synopsis.  cs_from_bytes re-raises if the
                # header/base CRC itself fails — no unprovable sketches.
                cs = cs_from_bytes(
                    frame_payload(self.batcher.blob, meta, verify_crc=False),
                    strict=False,
                )
            sk = _FrameSketch(
                meta=meta,
                table=segment_table(cs.base, self.batcher.device),
                eps_b=cs.eps_b_practical,
                scale=max(abs(cs.base.vmin), abs(cs.base.vmax)) + cs.eps_b_practical,
            )
            self._sketches[meta.offset] = sk
        return sk

    def _plan(self, series_id: int, t0: int, t1: int | None):
        if t1 is None:
            t1 = self.batcher.span(series_id)[1]
        touched = self.batcher.frames_overlapping(series_id, int(t0), int(t1))
        parts = []
        for meta in touched:
            sk = self._sketch(meta)
            a = max(int(t0), meta.t_lo) - meta.t_lo
            b = min(int(t1), meta.t_hi) - meta.t_lo
            parts.append(_Part(sk=sk, a=a, b=b, m=b - a))
        self.stats["frames_touched"] += len(parts)
        return int(t0), int(t1), parts

    @staticmethod
    def _wants_refine(eps: float | None, sk: _FrameSketch) -> bool:
        """Does ``eps`` ask for more than this frame's base guarantees?"""
        return eps is not None and not (eps > 0.0 and eps >= sk.eps_b)

    def _refine(self, part: _Part, eps: float) -> int:
        """Decode the cheapest sufficient layer prefix of one frame (via
        the shared serving LRU) and replace the part's estimate with the
        dense slice; returns the entropy decodes actually paid."""
        dec = self.batcher.decoder(part.sk.meta)
        k = resolve_or_finest(dec.cs, eps)
        intact = dec.intact_depth()
        if k > intact:
            # strict-mode decoders never carry corrupt layers (parse would
            # have raised), so reaching here means degraded_ok: serve the
            # finest intact prefix, flagged
            k = intact
            part.degraded = True
        paid0 = dec.layers_decoded
        part.dense = _host(dec.prefix(k)[part.a : part.b])
        paid = dec.layers_decoded - paid0
        self.stats["layers_paid"] += paid
        self.batcher.stats["layers_decoded"] += paid
        self.stats["frames_refined"] += 1
        g = dec.guarantee(k)
        part.exact = g == 0.0
        part.e_pt = point_margin(g, part.sk.scale)
        return paid

    # ------------------------------------------------------------------ #
    def aggregate(
        self,
        series_id: int,
        op: str,
        t0: int = 0,
        t1: int | None = None,
        eps: float | None = None,
    ) -> AggregateAnswer:
        """Interval answer for ``op`` over samples [t0, t1) of one series.

        min/max skip every frame whose segment-domain bounds cannot reach
        the answer; sum/mean/stddev refine each touched frame only when
        ``eps`` is finer than that frame's base guarantee."""
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregate op {op!r}: expected one of {AGG_OPS}")
        self.stats["queries"] += 1
        t0, t1, parts = self._plan(series_id, t0, t1)
        m = sum(p.m for p in parts)
        if op == "count":
            return AggregateAnswer(
                op=op, lo=float(m), hi=float(m), m=m, eps=0.0, exact=True,
                source="segments", frames_touched=len(parts),
            )
        if op in ("min", "max"):
            return self._extremum(op, parts, eps)
        return self._moments(op, parts, eps, m)

    def _extremum(self, op: str, parts, eps: float | None) -> AggregateAnswer:
        sign = 1.0 if op == "min" else -1.0  # work in "min" orientation
        for p, st in zip(parts, aggregate_parts([(p.sk.table, p.a, p.b) for p in parts])):
            p.est = sign * (st.vmin if op == "min" else st.vmax)
            p.e_pt = point_margin(p.sk.eps_b, p.sk.scale) + _fp_slack(p.sk.scale)
        # frame-skipping: a frame whose optimistic bound cannot beat the
        # best pessimistic bound can never contain the extremum
        best_hi = min(p.est + p.e_pt for p in parts)
        live = [p for p in parts if p.est - p.e_pt <= best_hi]
        skipped = len(parts) - len(live)
        paid = 0
        for p in live:
            if self._wants_refine(eps, p.sk):
                paid += self._refine(p, eps)
                sl = p.dense
                p.est = sign * float(sl.min() if op == "min" else sl.max())
                if not p.exact:
                    p.e_pt += _fp_slack(p.sk.scale)
            else:
                self.stats["segment_frames"] += 1
        self.stats["frames_skipped"] += skipped
        # skipped frames keep their (valid) sketch bounds: min composes
        lo = min(p.est - p.e_pt for p in parts)
        hi = min(p.est + p.e_pt for p in parts)
        if sign < 0:
            lo, hi = -hi, -lo
        g = max(p.e_pt for p in live)
        exact = all(p.exact for p in live) and lo == hi
        degraded = any(p.degraded for p in live)
        if degraded:
            self.stats["degraded"] += 1
        return AggregateAnswer(
            op=op, lo=lo, hi=hi, m=sum(p.m for p in parts),
            eps=0.0 if exact else g, exact=exact,
            source="dense" if all(p.dense is not None for p in parts) else (
                "segments" if all(p.dense is None for p in parts) else "mixed"),
            layers_paid=paid, frames_touched=len(parts),
            frames_skipped=skipped,
            frames_refined=sum(1 for p in live if p.dense is not None),
            degraded=degraded,
        )

    def _moments(self, op: str, parts, eps: float | None, m: int) -> AggregateAnswer:
        if m <= 0:
            raise ValueError("empty sample range")
        paid = 0
        # the unrefined parts' sums: one query step over all of them
        seg = [p for p in parts if not self._wants_refine(eps, p.sk)]
        for p, st in zip(seg, aggregate_parts([(p.sk.table, p.a, p.b) for p in seg])):
            p.est = st.total
        for p in parts:
            if self._wants_refine(eps, p.sk):
                paid += self._refine(p, eps)
                p.est = float(np.sum(p.dense))
                if not p.exact:
                    p.e_pt += _fp_slack(p.sk.scale)
            else:
                p.e_pt = point_margin(p.sk.eps_b, p.sk.scale) + _fp_slack(p.sk.scale)
                self.stats["segment_frames"] += 1
        scale = max(p.sk.scale for p in parts)
        total = sum(p.est for p in parts)
        mu = total / m
        single_exact = len(parts) == 1 and parts[0].exact
        # composing float partial sums across frames costs its own slack
        compose = 0.0 if single_exact else _fp_slack(scale)
        refined = sum(1 for p in parts if p.dense is not None)
        src = "dense" if refined == len(parts) else (
            "segments" if refined == 0 else "mixed")
        degraded = any(p.degraded for p in parts)
        if degraded:
            self.stats["degraded"] += 1
        common = dict(
            m=m, source=src, layers_paid=paid,
            frames_touched=len(parts), frames_refined=refined,
            degraded=degraded,
        )
        g = max(p.e_pt for p in parts)
        if op == "sum":
            e = sum(p.m * (p.e_pt + compose) for p in parts)
            lo, hi = (total, total) if single_exact else (total - e, total + e)
            return AggregateAnswer(op=op, lo=lo, hi=hi, eps=0.0 if single_exact else g,
                                   exact=single_exact, **common)
        if op == "mean":
            if single_exact:
                est = float(np.mean(parts[0].dense))
                return AggregateAnswer(op=op, lo=est, hi=est, eps=0.0, exact=True,
                                       **common)
            e = sum(p.m * p.e_pt for p in parts) / m + compose
            return AggregateAnswer(op=op, lo=mu - e, hi=mu + e, eps=g, exact=False,
                                   **common)
        # stddev: centering is a contraction in L2, so the per-point errors
        # bound the stddev shift by sqrt(Σ m_f e_f² / m)
        if single_exact:
            est = float(np.std(parts[0].dense))
            return AggregateAnswer(op=op, lo=est, hi=est, eps=0.0, exact=True, **common)
        seg = [p for p in parts if p.dense is None]
        central = iter(central_m2_parts([(p.sk.table, p.a, p.b) for p in seg], [mu] * len(seg)))
        m2 = 0.0
        for p in parts:
            m2 += float(((p.dense - mu) ** 2).sum()) if p.dense is not None else next(central)
        est = math.sqrt(max(m2, 0.0) / m)
        e = math.sqrt(sum(p.m * p.e_pt * p.e_pt for p in parts) / m) + compose
        return AggregateAnswer(op=op, lo=max(est - e, 0.0), hi=est + e, eps=g,
                               exact=False, **common)

    # ------------------------------------------------------------------ #
    def count_where(
        self,
        series_id: int,
        op: str,
        value: float,
        t0: int = 0,
        t1: int | None = None,
        eps: float | None = None,
    ) -> AggregateAnswer:
        """Integer interval for ``#{t : v_t <op> value}`` over [t0, t1).
        Each frame is first counted in closed form from its segments; only
        frames whose interval still straddles pay residual layers, one at
        a time, re-examining only the straddling samples."""
        if op not in CMP_OPS:
            raise ValueError(f"unknown comparison {op!r}: expected one of {CMP_OPS}")
        self.stats["queries"] += 1
        t0, t1, parts = self._plan(series_id, t0, t1)
        sgn = 1.0 if op in ("gt", "ge") else -1.0
        lo_total, hi_total = 0, 0
        g_worst = 0.0
        refined = skipped = paid_q = 0
        # both thresholds of every part: one query step
        margins = [point_margin(p.sk.eps_b, p.sk.scale) for p in parts]
        counts = count_parts([(p.sk.table, p.a, p.b) for p in parts], op,
                             [value + sgn * mg for mg in margins],
                             [value - sgn * mg for mg in margins])
        for p, (definite, possible) in zip(parts, counts):
            if definite == possible or not self._wants_refine(eps, p.sk):
                if definite == possible:
                    skipped += 1  # segment bounds settled it: no decode
                else:
                    self.stats["segment_frames"] += 1
                    g_worst = max(g_worst, p.sk.eps_b)
                lo_total += definite
                hi_total += possible
                continue
            dec = self.batcher.decoder(p.sk.meta)
            k = resolve_or_finest(dec.cs, eps)
            intact = dec.intact_depth()
            if k > intact:
                k = intact
                p.degraded = True
            n_in, straddle, g, paid = refine_count(
                dec, p.a, p.b, op, value, p.sk.scale, k
            )
            self.stats["layers_paid"] += paid
            self.batcher.stats["layers_decoded"] += paid
            paid_q += paid
            refined += 1
            g_worst = max(g_worst, g)
            lo_total += max(definite, n_in)
            hi_total += min(possible, n_in + straddle)
        self.stats["frames_skipped"] += skipped
        self.stats["frames_refined"] += refined
        degraded = any(p.degraded for p in parts)
        if degraded:
            self.stats["degraded"] += 1
        return AggregateAnswer(
            op=op, lo=float(lo_total), hi=float(hi_total), m=sum(p.m for p in parts),
            eps=g_worst, exact=lo_total == hi_total,
            source="dense" if refined == len(parts) else (
                "segments" if refined == 0 else "mixed"),
            layers_paid=paid_q, frames_touched=len(parts),
            frames_skipped=skipped, frames_refined=refined,
            degraded=degraded,
        )

    # ------------------------------------------------------------------ #
    def segments(self, series_id: int, t0: int = 0, t1: int | None = None) -> list[dict]:
        """Member segments overlapping [t0, t1), in container coordinates
        — pure directory+base reads, no residual decode."""
        _, _, parts = self._plan(series_id, t0, t1)
        recs: list[dict] = []
        for p in parts:
            recs.extend(segment_records(p.sk.table, p.a, p.b, offset=p.sk.meta.t_lo))
        return recs

    def topk_segments(
        self, series_id: int, k: int = 5, by: str = "length",
        t0: int = 0, t1: int | None = None,
    ) -> list[dict]:
        return rank_topk(self.segments(series_id, t0, t1), k, by)

    def similar_segments(
        self, series_id: int, slope: float, length: float, k: int = 5,
        t0: int = 0, t1: int | None = None,
    ) -> list[dict]:
        return rank_similar(self.segments(series_id, t0, t1), slope, length, k)
