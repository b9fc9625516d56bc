"""Sharded multi-tenant serving fleet, counterpart of
``repro.serving.fleet``: many gateways, one semantic truth.

:class:`ShrinkFleet` runs the single-process serving stack
(``RaggedBatcher`` -> ``SHRKS`` -> ``FaultTolerantGateway`` ->
``AnalyticsEngine``) once per shard, each shard owning a disjoint set of
series end to end on its device (``FleetPlan.device_of``; on one card all
shards share it).  Placement comes from :func:`repro_torch.parallel.plan_fleet`.

**Sharding is semantically invisible.**  For any partition of series
across any shard count, every series' frame bytes equal the single-shard
stack's, range queries decode to the same floats and analytics intervals
are equal, because the shard batchers run with ``scope="series"`` (frame
boundaries depend on each series' own ingest history) and a frame's
payload depends only on its samples and the codec's parameters.

**Knowledge-base replication.**  ``sync_kbs`` rebuilds the fleet-global
KB by merging the shard KBs (order-invariant) and records an epoch-tagged
sync point; with a ``kb_store`` each shard also gossips its KB into it
under a stable ``shard<i>`` handle.  ``seal()`` checks the routing
invariant (every frame's KB epoch within its shard's footer KB).

**Multi-tenant admission.**  :class:`TenantQuota` is a token bucket
(tokens = samples) on an injected clock.  Ingest beyond quota raises
:class:`QuotaExceededError`; queries beyond quota are shed to
``coarse_eps`` (flagged ``degraded``) or rejected when no coarse tier is
set.  A shard whose container is lost or corrupt degrades alone: its
queries come back typed errors or flagged in-bound answers while the
other shards serve byte-exact.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..core.errors import (
    BatcherFinalizedError,
    ConfigError,
    QuotaExceededError,
    ShrinkError,
)
from ..core.serialize import frame_payload, parse_framed_container
from ..core.streaming import KnowledgeBase, routing_metadata
from ..core.streaming import decode_range as _decode_range
from ..core.types import ShrinkConfig, merge_backend_stats
from ..parallel.fleet import FleetPlan, plan_fleet
from .batching import RangeQuery
from .gateway import FaultTolerantGateway, RetryPolicy
from .ragged import RaggedBatcher

__all__ = ["TenantQuota", "ShrinkFleet"]


class TenantQuota:
    """Per-tenant admission token bucket (tokens = samples) on an
    injectable clock: ``burst`` tokens capacity, refilled continuously at
    ``rate_per_s``.  ``try_take`` is the whole protocol — no partial
    grants, so admission is all-or-nothing and a huge request cannot
    starve forever on a trickle of tokens it keeps half-consuming."""

    def __init__(
        self,
        rate_per_s: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate_per_s < 0:
            raise ConfigError(f"rate_per_s must be >= 0, got {rate_per_s}")
        if burst <= 0:
            raise ConfigError(f"burst must be > 0, got {burst}")
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        if now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate_per_s
            )
        self._last = now

    def available(self) -> float:
        self._refill()
        return self._tokens

    def try_take(self, cost: float) -> bool:
        """Take ``cost`` tokens if the bucket holds them; False otherwise
        (nothing is consumed on refusal)."""
        self._refill()
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False


class ShrinkFleet:
    """The sharded serving fleet.  Lifecycle: ``submit``/``poll`` ingest
    (routed to per-shard ``scope="series"`` batchers), ``seal`` to per-shard
    SHRKS containers (idempotent; auto-invoked by the first query), then
    ``query``/``enqueue``+``run``/``aggregate``/``count_where`` route per
    shard through fault-tolerant gateways and analytics engines.

    Parameters mirror the single-process stack; fleet-specific knobs:

    n_shards:      shard count (placement from ``parallel.plan_fleet``).
    assignment:    explicit series->shard map/callable (tests quantify
                   over this; default = stable hash).
    tenant_of:     series_id -> tenant name (default: one "default"
                   tenant).  Quotas and shed accounting key on it.
    quotas:        {tenant: TenantQuota}; unlisted tenants are unmetered.
    coarse_eps:    the shed-to-coarse tier for over-quota / over-queue
                   queries (None = typed rejection instead).
    kb_sync_every: automatic ``sync_kbs`` after this many fleet-wide
                   flush events (None = only at seal / on demand).
    device:        the device type the shards run on (default the card;
                   ``"cpu"`` runs the kernels' plain versions).
    """

    def __init__(
        self,
        config: ShrinkConfig,
        eps_targets: list[float],
        n_shards: int = 1,
        decimals: int | None = None,
        backend: str = "rans",
        flush_samples: int | None = 8192,
        flush_deadline_s: float | None = None,
        max_buckets: int | None = None,
        assignment: Optional[Union[Mapping[int, int], Callable[[int], int]]] = None,
        tenant_of: Callable[[int], str] | None = None,
        quotas: Mapping[str, TenantQuota] | None = None,
        coarse_eps: Optional[float] = float("inf"),
        kb_sync_every: int | None = 4,
        kb_store=None,  # serving.kbstore.KBStore: shards gossip into it on sync
        retry: RetryPolicy | None = None,
        max_queue: int = 256,
        cache_frames: int = 32,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.config = config
        self.plan: FleetPlan = plan_fleet(n_shards, assignment, device=device)
        self.batchers = [
            RaggedBatcher(
                config,
                eps_targets=eps_targets,
                decimals=decimals,
                backend=backend,
                flush_samples=flush_samples,
                flush_deadline_s=flush_deadline_s,
                max_buckets=max_buckets,
                scope="series",
                clock=clock,
                device=self.plan.device_of(shard),
            )
            for shard in range(n_shards)
        ]
        self.tenant_of = tenant_of if tenant_of is not None else (lambda sid: "default")
        self.quotas = dict(quotas) if quotas else {}
        self.coarse_eps = coarse_eps
        self.kb_sync_every = kb_sync_every
        self.kb_store = kb_store
        self.global_kb = KnowledgeBase(config)
        self.kb_syncs: list[dict] = []
        self._flushes_since_sync = 0
        self._retry = retry
        self._gw_kwargs = dict(
            max_queue=max_queue,
            coarse_eps=coarse_eps,
            cache_frames=cache_frames,
            clock=clock,
            sleep=sleep,
            seed=seed,
        )
        self._blobs: Optional[list[bytes]] = None
        self._routing: Optional[list[dict]] = None
        self._gateways: list[Optional[FaultTolerantGateway]] = [None] * n_shards
        self._engines: list[Optional[AnalyticsEngine]] = [None] * n_shards
        self._down: dict[int, str] = {}
        self._quota_shed_qids: set[int] = set()
        self.completed: list[RangeQuery] = []
        self.stats = {
            "samples_ingested": 0,
            "frames_sealed": 0,
            "quota_rejected_ingest": 0,
            "quota_shed_queries": 0,
            "quota_rejected_queries": 0,
            "queries": 0,
            "shard_down_queries": 0,
            "kb_syncs": 0,
        }

    # -- topology ------------------------------------------------------- #
    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    def shard_of(self, series_id: int) -> int:
        return self.plan.shard_of(series_id)

    def _tenant(self, series_id: int, tenant: Optional[str]) -> str:
        return tenant if tenant is not None else self.tenant_of(int(series_id))

    # -- ingest --------------------------------------------------------- #
    def submit(
        self, series_id: int, values_chunk, tenant: Optional[str] = None
    ) -> list[tuple[int, int, int]]:
        """Route one series' next chunk to its shard's batcher; returns the
        frames that shard sealed.  Over-quota ingest raises a typed
        :class:`QuotaExceededError` — dropping samples to a coarse tier
        would be silent data loss, so ingest is admit-or-reject."""
        if self._blobs is not None:
            raise BatcherFinalizedError(
                "fleet already sealed", series_id=int(series_id)
            )
        sid = int(series_id)
        vals = np.asarray(values_chunk, dtype=np.float64).ravel()
        tq = self.quotas.get(self._tenant(sid, tenant))
        if tq is not None and vals.size and not tq.try_take(float(vals.size)):
            self.stats["quota_rejected_ingest"] += 1
            raise QuotaExceededError(
                f"tenant {self._tenant(sid, tenant)!r} ingest quota exhausted "
                f"({vals.size} samples > {tq.available():.0f} tokens)",
                series_id=sid,
            )
        self.stats["samples_ingested"] += int(vals.size)
        sealed = self.batchers[self.shard_of(sid)].submit(sid, vals)
        if sealed:
            self._note_flush(len(sealed))
        return sealed

    def poll(self) -> list[tuple[int, int, int]]:
        """Deadline sweep across every shard (drive from a timer loop)."""
        sealed: list[tuple[int, int, int]] = []
        for b in self.batchers:
            sealed.extend(b.poll())
        if sealed:
            self._note_flush(len(sealed))
        return sealed

    def _note_flush(self, n_frames: int) -> None:
        self.stats["frames_sealed"] += n_frames
        self._flushes_since_sync += 1
        if (
            self.kb_sync_every is not None
            and self._flushes_since_sync >= self.kb_sync_every
        ):
            self.sync_kbs()

    # -- knowledge-base replication ------------------------------------- #
    def sync_kbs(self) -> dict:
        """Rebuild the fleet-global KB by merging every shard KB (merge
        order cannot matter — the canonical maps are equal under any
        permutation, property-tested) and record an epoch-tagged sync
        point: per-shard entry counts + the global semantic snapshot id.
        Frames sealed before this sync reference only entries below their
        shard's recorded epoch, so any snapshot at/after the sync contains
        their refs.  With a ``kb_store`` attached, every shard also
        gossips its KB into the store under a stable ``shard<i>`` handle
        (replace semantics — repeated syncs of a growing shard KB never
        double-count) and the sync record carries the store's epoch-tagged
        state; after the last sync the store's semantic id equals the
        global KB's ``snapshot_id()`` whenever the shards are its only
        sources (property-tested)."""
        g = KnowledgeBase(self.config)
        shard_epochs = []
        for b in self.batchers:
            g.merge(b.kb)
            shard_epochs.append(b.kb.epoch)
        self.global_kb = g
        rec = {
            "sync": len(self.kb_syncs),
            "global_entries": g.epoch,
            "shard_epochs": shard_epochs,
            "semantic_id": g.snapshot_id(),
        }
        if self.kb_store is not None:
            for i, b in enumerate(self.batchers):
                self.kb_store.gossip(f"shard{i}", b.kb)
            rec["store"] = {
                "live": self.kb_store.live_count,
                "sem_id": self.kb_store.sem_id(),
            }
        self.kb_syncs.append(rec)
        self.stats["kb_syncs"] += 1
        self._flushes_since_sync = 0
        return rec

    # -- seal / routing -------------------------------------------------- #
    def seal(self) -> list[bytes]:
        """Finalize every shard batcher into its SHRKS container, run a
        final KB sync, and verify the routing invariant (every frame's
        ``kb_epoch`` <= its shard snapshot's entry count).  Idempotent —
        repeated calls return the same blobs."""
        if self._blobs is None:
            self._blobs = [b.finalize() for b in self.batchers]
            # finalize flushed whatever was still pending; re-base the
            # fleet frame counter on the authoritative per-shard totals
            self.stats["frames_sealed"] = sum(
                b.stats()["frames"] for b in self.batchers
            )
            self.sync_kbs()
            self._routing = [routing_metadata(bl) for bl in self._blobs]
            for shard, meta in enumerate(self._routing):
                if meta["frames"] and not meta["self_contained"]:
                    self._down[shard] = (
                        f"shard {shard} container violates the KB routing "
                        f"invariant (frame epoch {meta['max_frame_epoch']} > "
                        f"snapshot entries {meta['kb_entries']})"
                    )
        return list(self._blobs)

    @property
    def shard_blobs(self) -> list[bytes]:
        return self.seal()

    def routing(self) -> list[dict]:
        """Per-shard ``routing_metadata`` (series ids, frame KB epochs, KB
        snapshot ids) — what a fleet router would gossip."""
        self.seal()
        return [dict(m) for m in self._routing]

    def inject_shard_blob(self, shard: int, blob: bytes) -> None:
        """Replace one shard's container and reset its serving stack (the
        chaos suite's shard-kill hook; also the path a real repair/restore
        would take).  Other shards are untouched."""
        self.seal()
        self._blobs[shard] = bytes(blob)
        self._gateways[shard] = None
        self._engines[shard] = None
        self._down.pop(shard, None)

    def shards_down(self) -> dict[int, str]:
        """Shards currently out of service, with the typed reason."""
        return dict(self._down)

    # -- per-shard serving stacks ---------------------------------------- #
    def gateway(self, shard: int) -> FaultTolerantGateway:
        """The shard's fault-tolerant gateway (built lazily over its
        container).  A container that cannot even parse marks the shard
        down and raises the typed error — queries to OTHER shards are
        unaffected."""
        self.seal()
        if shard in self._down:
            raise ShrinkError(self._down[shard])
        gw = self._gateways[shard]
        if gw is None:
            try:
                gw = FaultTolerantGateway(
                    self._blobs[shard], retry=self._retry, **self._gw_kwargs,
                    device=self.plan.device_of(shard),
                )
            except ShrinkError as e:
                self._down[shard] = f"{type(e).__name__}: {e}"
                raise
            self._gateways[shard] = gw
        return gw

    def engine(self, shard: int):
        """The shard's analytics engine (:class:`repro_torch.analytics.
        AnalyticsEngine`) on the shard's device, sharing the gateway's
        frame LRU (range decodes and aggregates never decode a layer
        twice)."""
        # deferred: repro_torch.analytics imports serving.batching, so a
        # module-level import would make the package cycle order-dependent
        from ..analytics import AnalyticsEngine

        eng = self._engines[shard]
        if eng is None:
            eng = AnalyticsEngine(self.gateway(shard).batcher)
            self._engines[shard] = eng
        return eng

    # -- queries --------------------------------------------------------- #
    def _admit_query(self, q: RangeQuery, tenant: Optional[str]) -> Optional[str]:
        """Quota admission for one query.  Returns None when admitted
        (possibly shed to coarse — ``q.eps`` is then widened and the qid
        recorded), or the typed error string when rejected outright."""
        tq = self.quotas.get(self._tenant(q.series_id, tenant))
        if tq is None or tq.try_take(float(max(q.t1 - q.t0, 1))):
            return None
        if self.coarse_eps is not None:
            q.eps = max(q.eps, self.coarse_eps)
            self._quota_shed_qids.add(q.qid)
            self.stats["quota_shed_queries"] += 1
            return None
        self.stats["quota_rejected_queries"] += 1
        e = QuotaExceededError(
            f"tenant {self._tenant(q.series_id, tenant)!r} query quota "
            f"exhausted and no coarse tier configured",
            series_id=q.series_id,
        )
        return f"{type(e).__name__}: {e}"

    def query(
        self,
        q: RangeQuery,
        tenant: Optional[str] = None,
        deadline_s: float | None = None,
    ) -> RangeQuery:
        """Serve one range query synchronously through its shard's gateway.
        Failures land typed in ``q.error`` (quota rejection, shard down,
        or anything the gateway itself types) — never an unhandled raise,
        never a silent wrong answer."""
        self.stats["queries"] += 1
        rejected = self._admit_query(q, tenant)
        if rejected is not None:
            q.error = rejected
            self.completed.append(q)
            return q
        try:
            gw = self.gateway(self.shard_of(q.series_id))
        except ShrinkError as e:
            self.stats["shard_down_queries"] += 1
            q.error = f"{type(e).__name__}: {e}"
            self.completed.append(q)
            return q
        gw.serve(q, deadline_s=deadline_s)
        if q.qid in self._quota_shed_qids and q.error is None:
            q.degraded = True
        self.completed.append(q)
        return q

    def enqueue(self, q: RangeQuery, tenant: Optional[str] = None) -> None:
        """Queue a query on its shard's gateway (bounded admission: beyond
        the queue bound the gateway sheds to coarse / raises
        :class:`BackpressureError`).  Quota rejection raises the typed
        :class:`QuotaExceededError` here — there is no result object to
        park the error on until ``run``."""
        rejected = self._admit_query(q, tenant)
        if rejected is not None:
            raise QuotaExceededError(rejected, series_id=q.series_id)
        self.gateway(self.shard_of(q.series_id)).submit(q)

    def run(self, deadline_s: float | None = None) -> list[RangeQuery]:
        """Drain every shard gateway's queue; returns the completed
        queries (quota-shed ones flagged degraded)."""
        done: list[RangeQuery] = []
        for shard in range(self.n_shards):
            gw = self._gateways[shard]
            if gw is None or not gw.queue:
                continue
            for q in gw.run(deadline_s=deadline_s):
                self.stats["queries"] += 1
                if q.qid in self._quota_shed_qids and q.error is None:
                    q.degraded = True
                done.append(q)
        self.completed.extend(done)
        return done

    # -- analytics ------------------------------------------------------- #
    def aggregate(
        self,
        series_id: int,
        op: str,
        t0: int = 0,
        t1: int | None = None,
        eps: float | None = None,
        tenant: Optional[str] = None,
    ):
        """Interval-guaranteed aggregate through the series' shard engine.
        Over-quota requests are shed to the segment tier (``eps=None`` —
        zero entropy work) and flagged ``degraded``: the interval is wider
        than asked but still contains the truth."""
        sid = int(series_id)
        tq = self.quotas.get(self._tenant(sid, tenant))
        shed = False
        if tq is not None:
            hi = t1 if t1 is not None else self.engine(self.shard_of(sid)).span(sid)[1]
            if not tq.try_take(float(max(hi - t0, 1))):
                self.stats["quota_shed_queries"] += 1
                eps = None
                shed = True
        ans = self.engine(self.shard_of(sid)).aggregate(sid, op, t0, t1, eps=eps)
        return replace(ans, degraded=True) if shed else ans

    def count_where(
        self,
        series_id: int,
        op: str,
        value: float,
        t0: int = 0,
        t1: int | None = None,
        eps: float | None = None,
    ):
        sid = int(series_id)
        return self.engine(self.shard_of(sid)).count_where(
            sid, op, value, t0, t1, eps=eps
        )

    def topk_segments(self, series_id: int, k: int = 5, by: str = "length"):
        sid = int(series_id)
        return self.engine(self.shard_of(sid)).topk_segments(sid, k=k, by=by)

    # -- differential plumbing ------------------------------------------- #
    def series_frames(self, series_id: int) -> list[tuple[int, int, bytes]]:
        """One series' sealed frames as ``(t_lo, t_hi, payload_bytes)`` in
        time order, pulled from its shard's container — the unit the
        cross-shard byte-identity differential compares."""
        sid = int(series_id)
        blob = self.seal()[self.shard_of(sid)]
        metas, _ = parse_framed_container(blob)
        mine = sorted((m for m in metas if m.series_id == sid), key=lambda m: m.t_lo)
        return [(m.t_lo, m.t_hi, frame_payload(blob, m)) for m in mine]

    def decode_range(self, series_id: int, t0: int, t1: int, eps: float) -> torch.Tensor:
        """Direct (armor-free) range decode against the shard container,
        on the shard's device."""
        sid = int(series_id)
        shard = self.shard_of(sid)
        return _decode_range(
            self.seal()[shard], sid, t0, t1, eps, device=self.plan.device_of(shard)
        )

    # -- introspection --------------------------------------------------- #
    def fleet_stats(self) -> dict:
        st = dict(self.stats)
        st["n_shards"] = self.n_shards
        st["shards_down"] = sorted(self._down)
        st["global_kb"] = self.global_kb.stats() if self.global_kb.entries else {}
        st["shards"] = [b.stats() for b in self.batchers]
        backends: dict[str, dict[str, int]] = {}
        for shard in st["shards"]:
            merge_backend_stats(backends, shard.get("backends", {}))
        st["backends"] = backends
        st["gateways"] = [
            (gw.stats if gw is not None else None) for gw in self._gateways
        ]
        return st
