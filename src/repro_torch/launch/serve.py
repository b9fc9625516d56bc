"""Serving launcher of the port, counterpart of ``repro.launch.serve``:

    # LM decode loop (continuous batching) over any of the ten configs at
    # random init (dense, MoE with MLA, hybrid RG-LRU, RWKV, enc-dec, VLM)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
        --requests 16 --slots 8 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b

    # time-series range queries against a freshly streamed SHRKS container
    PYTHONPATH=src python -m repro_torch.launch.serve --mode range \
        --series 8 --points 65536 --frame-len 8192 --queries 256

    # compressed-domain analytics: aggregates / threshold counts / top-k
    # straight off the container, differentially checked against numpy
    PYTHONPATH=src python -m repro_torch.launch.serve --mode analytics \
        --series 8 --points 65536 --frame-len 8192 --queries 256

    # ragged gateway ingest: sensors at rates over 2.5 decades through the
    # RaggedBatcher (size/deadline admission, ragged compress_batch) -> SHRKS
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ingest \
        --series 64 --ticks 200 --flush-samples 131072

    # cross-archive KB store: archives in ref mode against one KBStore,
    # detach, compact, spill and load, every decode compared exactly
    PYTHONPATH=src python -m repro_torch.launch.serve --mode kbstore

    # chaos campaign: seeded corruptions, transient decode faults and
    # overload against the fault-tolerant gateway, then KB-store faults;
    # exits non-zero on any silent corruption
    PYTHONPATH=src python -m repro_torch.launch.serve --mode chaos \
        --series 4 --points 16384 --frame-len 2048 --fault-rate 0.01

    # sharded multi-tenant fleet: mixed ingest, range and analytics traffic
    # over N shards with tenant quotas, the 1-shard oracle and a shard kill
    PYTHONPATH=src python -m repro_torch.launch.serve --mode fleet --shards 4

All run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions) with the reference's seeded traffic and exit non-zero when a
check fails: every request served to its token budget, every answer
within its bound of the raw values (or a typed error where a fault was
injected), every cross-shard frame byte-identical.  Answers are tensors
on the device; each check reads one back once.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..analytics import AnalyticsEngine
from ..configs import ARCHS, get_config, reduced_config
from ..core import BYTES_PER_ROW, ShrinkConfig, ShrinkStreamCodec
from ..core.device import resolve_device
from ..core.errors import QuotaExceededError, ShrinkError, StaleSnapshotError
from ..core.serialize import parse_framed_container, read_snapshot_ref
from ..core.streaming import decode_range, decode_series
from ..data.synthetic import ragged_sensor_traffic
from ..models import build_model
from ..serving import (
    ContinuousBatcher,
    FaultTolerantGateway,
    KBStore,
    RaggedBatcher,
    RangeQuery,
    RangeQueryBatcher,
    Request,
    RetryPolicy,
    ShrinkFleet,
    TenantQuota,
)
from ..serving.kbstore import resolve_container_kb, snapshot_from_bytes
from ..testing import ChaosInjector, flip_byte, stale_snapshot_ref, truncate

__all__ = ["analytics_traffic", "main", "ragged_ingest", "range_traffic", "run_fleet_sim",
           "sensor_values"]

AGG_OPS = ["min", "max", "sum", "mean", "stddev"]


def sensor_values(series: int, points: int, seed: int = 0) -> np.ndarray:
    """The gateway's seeded sensors: random walks plus noise on a
    4-decimal grid, float64 [series, points]."""
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.standard_normal((series, points)) * 0.05, axis=1)
    v += rng.standard_normal((series, points)) * 0.02
    return np.round(v, 4)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def range_traffic(batcher: RangeQueryBatcher, v: np.ndarray, queries: int, frame_len: int,
                  eps: float, seed: int = 1) -> dict:
    """Submit ``queries`` seeded range queries at ``eps``, serve them, and
    hold each result within eps of the raw values.  Returns the counts and
    the worst error; ``failed`` counts queries that errored or missed."""
    s, n = v.shape
    qrng = np.random.default_rng(seed)
    for qid in range(queries):
        sid = int(qrng.integers(0, s))
        t_lo = int(qrng.integers(0, n - 16))
        t_hi = int(min(n, t_lo + qrng.integers(16, frame_len)))
        batcher.submit(RangeQuery(qid=qid, series_id=sid, t0=t_lo, t1=t_hi, eps=eps))
    _sync(batcher.device)
    t0 = time.perf_counter()
    done = batcher.run()
    _sync(batcher.device)
    dt = time.perf_counter() - t0
    worst, failed = 0.0, 0
    for q in done:
        if q.error is not None:
            failed += 1
            continue
        truth = torch.as_tensor(v[q.series_id, q.t0 : q.t1], device=q.result.device)
        err = float((q.result - truth).abs().max())
        worst = max(worst, err)
        failed += err > eps * (1 + 1e-9)
    return {"queries": len(done), "seconds": dt, "failed": failed, "max_abs_err": worst}


def analytics_traffic(eng: AnalyticsEngine, v: np.ndarray, queries: int, frame_len: int,
                      tiers: list[float], seed: int = 1, answers: list | None = None) -> dict:
    """The reference's mixed workload: a third zero-decode sketch
    aggregates, a third tiered aggregates, a third exact ``count_where``
    (``gt`` a seeded threshold).  Every interval must contain the numpy
    truth and every count must be exact; ``answers`` collects them."""
    s, n = v.shape
    qrng = np.random.default_rng(seed)
    failed = 0
    _sync(eng.batcher.device)
    t0 = time.perf_counter()
    for qid in range(queries):
        sid = int(qrng.integers(0, s))
        lo = int(qrng.integers(0, n - 16))
        hi = int(min(n, lo + qrng.integers(16, 4 * frame_len)))
        sl = v[sid, lo:hi]
        kind = qid % 3
        if kind == 0:  # zero-decode sketch aggregate off the segments
            op = AGG_OPS[qid % len(AGG_OPS)]
            ans = eng.aggregate(sid, op, lo, hi, eps=None)
        elif kind == 1:  # tiered aggregate (refine loop through the LRU)
            op = AGG_OPS[qid % len(AGG_OPS)]
            ans = eng.aggregate(sid, op, lo, hi, eps=tiers[qid % len(tiers)])
        else:  # exact threshold count: refine only straddling frames
            c = float(qrng.uniform(sl.min(), sl.max() + 1e-9))
            ans = eng.count_where(sid, "gt", c, lo, hi, eps=0.0)
        if kind != 2:
            truth = {"min": sl.min, "max": sl.max, "sum": sl.sum, "mean": sl.mean,
                     "stddev": sl.std}[op]()
        else:
            truth = float((sl > c).sum())
        ok = ans.lo - 1e-9 <= truth <= ans.hi + 1e-9 and (kind != 2 or ans.exact)
        failed += not ok
        if answers is not None:
            answers.append(ans)
    _sync(eng.batcher.device)
    dt = time.perf_counter() - t0
    return {"queries": queries, "seconds": dt, "failed": failed}


def _serve_model(args, dev: torch.device) -> int:
    """Continuous batching over any config's model at random init (seed 0):
    the reference's seeded prompts of 4-15 tokens, greedy decode, no EOS.
    As in the reference, a VLM's and an encoder-decoder's cross caches
    start empty (every context position masked)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(
        decode_fn=lambda t, c, i: model.decode_step(params, t, c, i),
        make_caches=lambda: model.make_decode_caches(args.slots, args.max_seq, device=dev),
        n_slots=args.slots,
        eos_token=-1,
        device=dev,
    )
    for rid in range(args.requests):
        batcher.submit(Request(
            rid=rid,
            prompt=rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    _sync(dev)
    t0 = time.perf_counter()
    done = batcher.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.prompt) + len(r.generated) for r in done)
    failed = args.requests - sum(len(r.generated) == args.max_new for r in done)
    print(f"served {len(done)} requests, {toks} tokens, {dt:.4f}s ({toks/dt:.2f} tok/s), "
          f"failed={failed}")
    return 0 if failed == 0 else 1


def _serve_range(args, dev: torch.device) -> int:
    """Stream the sensors chunk-interleaved into a SHRKS container, then
    serve seeded range queries through the frame-cached batcher."""
    v = sensor_values(args.series, args.points)
    s, n = v.shape
    vmin, vmax = float(v.min()), float(v.max())
    cfg = ShrinkConfig(eps_b=0.05 * max(vmax - vmin, 1e-12), lam=1e-4)
    eps = args.eps * (vmax - vmin)
    codec = ShrinkStreamCodec(
        cfg, eps_targets=[eps], backend="rans",
        value_range=(vmin, vmax), frame_len=args.frame_len, device=dev,
    )
    t0 = time.perf_counter()
    for c0 in range(0, n, args.chunk):  # interleaved chunk-at-a-time ingest
        for sid in range(s):
            codec.ingest(v[sid, c0 : c0 + args.chunk], series_id=sid)
    blob = codec.finalize()
    _sync(dev)
    dt_ingest = time.perf_counter() - t0
    mb = s * n * BYTES_PER_ROW / 1e6
    st = codec.stats()
    print(
        f"ingested {s} series x {n} samples in {dt_ingest:.2f}s "
        f"({mb/dt_ingest:.1f} MB/s), {st['frames']} frames, "
        f"CR={s*n*BYTES_PER_ROW/len(blob):.1f}, kb={st['kb']}"
    )
    batcher = RangeQueryBatcher(blob, cache_frames=args.cache_frames, device=dev)
    res = range_traffic(batcher, v, args.queries, args.frame_len, eps)
    bs = batcher.stats
    print(
        f"served {res['queries']} range queries in {res['seconds']:.3f}s "
        f"({res['queries']/res['seconds']:.0f} q/s), frames decoded={bs['frames_decoded']} "
        f"cache hits={bs['frame_hits']}, max |err|={res['max_abs_err']:.2e} (eps={eps:.2e}), "
        f"failed={res['failed']}"
    )
    return 0 if res["failed"] == 0 else 1


def _serve_analytics(args, dev: torch.device) -> int:
    """Compressed-domain analytics over a freshly streamed container: the
    mixed workload of :func:`analytics_traffic`, every answer checked."""
    v = sensor_values(args.series, args.points)
    s, n = v.shape
    vmin, vmax = float(v.min()), float(v.max())
    vrng = max(vmax - vmin, 1e-12)
    cfg = ShrinkConfig(eps_b=0.02 * vrng, lam=1e-4)
    tiers = [1e-2 * vrng, 1e-3 * vrng, 0.0]
    codec = ShrinkStreamCodec(
        cfg, eps_targets=tiers, decimals=4, backend="rans",
        value_range=(vmin, vmax), frame_len=args.frame_len, device=dev,
    )
    for sid in range(s):
        codec.ingest(v[sid], series_id=sid)
    blob = codec.finalize()
    print(
        f"streamed {s} series x {n} samples into {codec.stats()['frames']} frames, "
        f"CR={s * n * BYTES_PER_ROW / len(blob):.1f}"
    )
    eng = AnalyticsEngine(RangeQueryBatcher(blob, cache_frames=args.cache_frames, device=dev))
    res = analytics_traffic(eng, v, args.queries, args.frame_len, tiers)
    st = eng.stats
    top = eng.topk_segments(0, k=3, by="length")
    print(
        f"answered {res['queries']} queries in {res['seconds']:.3f}s "
        f"({res['queries'] / res['seconds']:.0f} q/s), failed={res['failed']}: "
        f"{st['segment_frames']} segment-domain frames, "
        f"{st['frames_skipped']} skipped, {st['frames_refined']} refined, "
        f"{st['layers_paid']} layers paid "
        f"(serving LRU hits={eng.batcher.stats['frame_hits']})"
    )
    print(f"top-3 longest segments of series 0: {[(r['t0'], r['length']) for r in top]}")
    return 0 if res["failed"] == 0 else 1

def ragged_ingest(batcher: RaggedBatcher, traffic) -> tuple[bytes, dict]:
    """Deliver ``traffic`` (one list of ``(sid, chunk)`` a tick) to the
    batcher, polling its deadline after every tick, then finalize.
    Returns (the container, each series' chunks in arrival order)."""
    history: dict[int, list[np.ndarray]] = {}
    for tick in traffic:
        for sid, chunk in tick:
            history.setdefault(sid, []).append(chunk)
            batcher.submit(sid, chunk)
        batcher.poll()
    return batcher.finalize(), history


def _serve_ingest(args, dev: torch.device) -> int:
    """Ragged gateway simulation: sensors publish at rates spanning orders
    of magnitude; each tick's chunks go into the RaggedBatcher, whose
    size/deadline admission decides when the pending ragged batch
    compresses into SHRKS frames.  Ends with seeded range decodes held to
    eps against the raw data."""
    s = args.series
    t0 = time.perf_counter()
    traffic = ragged_sensor_traffic(s, args.ticks, seed=0)
    dt_gen = time.perf_counter() - t0
    cfg = ShrinkConfig(eps_b=0.4, lam=1e-4)
    eps = args.eps * 8.0  # value walks live in roughly [-4, 4]
    batcher = RaggedBatcher(
        cfg, eps_targets=[eps], backend="rans",
        flush_samples=args.flush_samples,
        flush_deadline_s=args.flush_deadline,
        max_buckets=args.buckets,
        device=dev,
    )
    _sync(dev)
    t0 = time.perf_counter()
    blob, history = ragged_ingest(batcher, traffic)
    _sync(dev)
    dt = time.perf_counter() - t0
    st = batcher.stats()
    mb = st["samples_ingested"] * BYTES_PER_ROW / 1e6
    print(
        f"ingested {st['samples_ingested']:,} samples from {st['series']} sensors "
        f"in {dt:.2f}s ({mb/dt:.1f} MB/s; traffic generated in {dt_gen:.2f}s), "
        f"{st['frames']} frames / {st['flushes']} flushes, "
        f"CR={st['samples_ingested']*BYTES_PER_ROW/len(blob):.1f}, kb={st['kb']}"
    )
    worst = 0.0
    qrng = np.random.default_rng(1)
    checked = 0
    for sid in range(s):
        full = np.concatenate(history[sid]) if sid in history else np.zeros(0)
        if full.size < 2:
            continue
        for _ in range(args.verify_queries):
            lo = int(qrng.integers(0, full.size - 1))
            hi = int(min(full.size, lo + 1 + qrng.integers(0, 4096)))
            got = decode_range(blob, sid, lo, hi, eps, device=dev).cpu().numpy()
            worst = max(worst, float(np.abs(got - full[lo:hi]).max()))
            checked += 1
    print(f"verified {checked} range decodes, max |err|={worst:.2e} (eps={eps:.2e})")
    return 0 if worst <= eps * (1 + 1e-9) else 1


def _serve_chaos(args, dev: torch.device) -> int:
    """Seeded chaos campaign against the fault-tolerant gateway.

    Phase 1 (corruption): each round injects ONE random fault (byte flip,
    truncation, frame-CRC smash or frame drop) into a copy of a pristine
    SHRKS container and fires range queries at a gateway over the mutant.
    Every answer must carry a typed error or lie within its own reported
    ``achieved`` bound of the raw data; anything else is a SILENT
    corruption and fails the run.

    Phase 2 (transient faults and overload): the pristine container served
    through a flaky decode step (seeded ``TransientError`` at
    ``--fault-rate``) with a small admission queue: retries with backoff,
    the per-frame breaker, deadlines and shed-to-coarse, every answer
    checked.  It runs on the real clock, so its tallies vary between runs.

    Phase 3 (KB store): byte flips and truncations of an SHKS snapshot
    must raise typed errors; a stale ``kb_snapshot_ref`` must fall back to
    the inline footer KB (both-mode container) or raise
    ``StaleSnapshotError`` (ref-only), and decode of the faulted
    containers must stay exact.
    """
    v = sensor_values(args.series, args.points)
    s, n = v.shape
    vmin, vmax = float(v.min()), float(v.max())
    cfg = ShrinkConfig(eps_b=0.05 * max(vmax - vmin, 1e-12), lam=1e-4)
    eps = args.eps * (vmax - vmin)
    codec = ShrinkStreamCodec(
        cfg, eps_targets=[eps], backend="rans",
        value_range=(vmin, vmax), frame_len=args.frame_len, device=dev,
    )
    for sid in range(s):
        codec.ingest(v[sid], series_id=sid)
    blob = codec.finalize()
    print(
        f"pristine container: {s} series x {n} samples, "
        f"{codec.stats()['frames']} frames, {len(blob)} bytes, "
        f"CR={s*n*BYTES_PER_ROW/len(blob):.1f}"
    )

    def check(q) -> str:
        """'error' (typed), 'ok' (within the requested eps), 'degraded'
        (flagged, within its own achieved bound) or 'SILENT'."""
        if q.error is not None:
            return "error"
        err = float(np.abs(q.result.cpu().numpy() - v[q.series_id, q.t0 : q.t1]).max())
        if err > max(q.achieved, q.eps) * (1 + 1e-9):
            return "SILENT"
        return "degraded" if q.degraded else "ok"

    chaos = ChaosInjector(seed=args.chaos_seed)
    qrng = np.random.default_rng(2)
    tally = {"ok": 0, "degraded": 0, "error": 0, "SILENT": 0}
    by_kind: dict[str, int] = {}
    unreadable = 0
    t0 = time.perf_counter()
    for _ in range(args.corruptions):
        mutant, fault = chaos.corrupt(blob)
        by_kind[fault.kind] = by_kind.get(fault.kind, 0) + 1
        try:
            gw = FaultTolerantGateway(mutant, seed=args.chaos_seed, device=dev)
        except ShrinkError:
            unreadable += 1  # detected at parse: typed, never silent
            continue
        for qid in range(args.queries_per_fault):
            sid = int(qrng.integers(0, s))
            lo = int(qrng.integers(0, n - 16))
            hi = int(min(n, lo + qrng.integers(16, 2 * args.frame_len)))
            gw.submit(RangeQuery(qid=qid, series_id=sid, t0=lo, t1=hi, eps=eps))
        for q in gw.run(deadline_s=10.0):
            tally[check(q)] += 1
    dt = time.perf_counter() - t0
    kinds = ", ".join(f"{k}={c}" for k, c in sorted(by_kind.items()))
    print(
        f"phase 1: {args.corruptions} corrupt containers ({kinds}) in {dt:.2f}s — "
        f"{unreadable} rejected at parse; per-query: {tally['ok']} ok, "
        f"{tally['degraded']} degraded, {tally['error']} typed errors, "
        f"{tally['SILENT']} SILENT"
    )

    gw = FaultTolerantGateway(
        blob,
        retry=RetryPolicy(max_attempts=4, base_delay_s=1e-4, max_delay_s=1e-3),
        max_queue=args.queries // 4 or 1,
        seed=args.chaos_seed,
        device=dev,
    )
    gw.frame_decode = chaos.flaky(gw.frame_decode, fail_rate=args.fault_rate)
    tally2 = {"ok": 0, "degraded": 0, "error": 0, "SILENT": 0}
    t0 = time.perf_counter()
    for qid in range(args.queries):
        sid = int(qrng.integers(0, s))
        lo = int(qrng.integers(0, n - 16))
        hi = int(min(n, lo + qrng.integers(16, 2 * args.frame_len)))
        gw.submit(RangeQuery(qid=qid, series_id=sid, t0=lo, t1=hi, eps=eps))
        # drain in bursts once the bounded queue has overflowed, so the
        # tail of each burst is shed to the coarse tier
        if len(gw.queue) >= gw.max_queue + 4:
            for q in gw.run(deadline_s=5.0):
                tally2[check(q)] += 1
    for q in gw.run(deadline_s=5.0):
        tally2[check(q)] += 1
    dt = time.perf_counter() - t0
    st = gw.stats
    print(
        f"phase 2: {st['queries']} queries through flaky decode "
        f"(fault rate {args.fault_rate:g}) in {dt:.2f}s — "
        f"{st['retries']} retries, {st['transient_failures']} transient faults, "
        f"{st['breaker_opens']} breaker opens, {st['shed']} shed to coarse, "
        f"{st['deadline_exceeded']} deadline misses; per-query: "
        f"{tally2['ok']} ok, {tally2['degraded']} degraded, "
        f"{tally2['error']} typed errors, {tally2['SILENT']} SILENT"
    )

    store = KBStore(cfg)

    def _store_codec(source, inline):
        sc = ShrinkStreamCodec(
            cfg, eps_targets=[eps], backend="rans",
            value_range=(vmin, vmax), frame_len=args.frame_len,
            kb_store=store, inline_kb=inline, source=source, device=dev,
        )
        sc.ingest(v[0])
        return sc.finalize()

    ref_only = _store_codec("ref-only", None)
    both = _store_codec("both", True)
    snap = store.snapshots[-1].blob
    frng = np.random.default_rng(args.chaos_seed + 3)
    tally3 = {"typed": 0, "fallback": 0, "SILENT": 0}
    n_snap_faults = max(16, args.corruptions)
    for _ in range(n_snap_faults):
        if frng.random() < 0.5:
            bad, _ = flip_byte(snap, int(frng.integers(0, len(snap))),
                               bit=int(frng.integers(0, 8)))
        else:
            bad, _ = truncate(snap, int(frng.integers(0, len(snap))))
        try:
            snapshot_from_bytes(bad)
            tally3["SILENT"] += 1  # a corrupt snapshot decoded without complaint
        except ShrinkError:
            tally3["typed"] += 1
    pristine = decode_series(ref_only, 0, eps, device=dev)
    stale_ref_only, _ = stale_snapshot_ref(ref_only)
    try:
        resolve_container_kb(stale_ref_only, store)
        tally3["SILENT"] += 1  # a stale ref bound to the wrong snapshot
    except StaleSnapshotError:
        tally3["typed"] += 1
    stale_both, _ = stale_snapshot_ref(both)
    _, origin = resolve_container_kb(stale_both, store)
    tally3["fallback" if origin == "inline-fallback" else "SILENT"] += 1
    for mutant in (stale_ref_only, stale_both):
        if not torch.equal(decode_series(mutant, 0, eps, device=dev), pristine):
            tally3["SILENT"] += 1  # a footer fault must never move frame bytes
    print(
        f"phase 3: {n_snap_faults} snapshot faults + 2 stale refs — "
        f"{tally3['typed']} typed, {tally3['fallback']} inline fallbacks, "
        f"{tally3['SILENT']} SILENT"
    )

    silent = tally["SILENT"] + tally2["SILENT"] + tally3["SILENT"]
    print(f"silent corruptions: {silent}" + ("" if silent == 0 else "  <-- FAIL"))
    return 0 if silent == 0 else 1


def _serve_kbstore(args, dev: torch.device) -> int:
    """Cross-archive KB store: small archives tiling a shared motif bank
    are encoded self-contained (inline footer KB) and in ref mode against
    one :class:`KBStore`, and every archive is decoded both ways and
    compared exactly.  Then a third of the corpus is detached, the store
    compacted (the survivors re-based and decoded again), its snapshots
    spilled and loaded: the re-based containers' refs must resolve in the
    loaded store to the writers' exact KB views."""
    import tempfile

    n_arch = 8 if args.quick else 32
    rng = np.random.default_rng(args.chaos_seed)
    motif_len, tiles = 128, 2
    bank = []
    for _ in range(8):  # piecewise-linear motifs: recurring KB lines
        knots = np.sort(rng.choice(np.arange(4, motif_len - 4), 15, replace=False))
        xs = np.concatenate([[0], knots, [motif_len - 1]])
        ys = np.round(rng.uniform(-4.0, 4.0, size=xs.size), 1)
        bank.append(np.round(np.interp(np.arange(motif_len), xs, ys), 3))
    series = [
        np.concatenate([bank[rng.integers(0, len(bank))] for _ in range(tiles)])
        for _ in range(n_arch)
    ]
    corpus = np.concatenate(series)
    vr = (float(corpus.min()), float(corpus.max()))
    cfg = ShrinkConfig(eps_b=0.05 * (vr[1] - vr[0]), lam=1e-3)
    eps = 0.02 * (vr[1] - vr[0])

    def encode(v, store=None, source=None):
        sc = ShrinkStreamCodec(
            cfg, eps_targets=[eps], decimals=3, backend="best",
            value_range=vr, frame_len=tiles * motif_len,
            kb_store=store, source=source, device=dev,
        )
        sc.ingest(v)
        return sc, sc.finalize()

    def same_decode(a: bytes, b: bytes) -> bool:
        return torch.equal(decode_series(a, 0, eps, device=dev),
                           decode_series(b, 0, eps, device=dev))

    inline = [encode(v)[1] for v in series]
    store = KBStore(cfg)
    writers = [encode(v, store, f"ar{i}")[0] for i, v in enumerate(series)]
    inline_bytes = sum(len(b) for b in inline)
    shared_bytes = (
        sum(len(store.container(f"ar{i}")) for i in range(n_arch))
        + len(store.snapshots[-1].blob)
    )
    st = store.stats()
    print(
        f"corpus: {n_arch} archives x {tiles * motif_len} samples; "
        f"inline={inline_bytes:,}B (KB share "
        f"{sum(len(parse_framed_container(b)[1]) for b in inline) / inline_bytes:.1%}), "
        f"shared={shared_bytes:,}B -> CR={shared_bytes / inline_bytes:.3f}"
    )
    print(
        f"store: {st['live']} live entries, dedup {st['dedup_ratio']:.1f}x, "
        f"{st['snapshots']} snapshots"
    )

    bad = sum(not same_decode(inline[i], store.container(f"ar{i}")) for i in range(n_arch))
    print(f"differential decode (ref vs inline): {n_arch - bad}/{n_arch} exact")

    dropped = list(range(0, n_arch, 3))
    old_refs = {i: read_snapshot_ref(store.container(f"ar{i}")) for i in dropped}
    for i in dropped:
        store.detach(f"ar{i}")
    rep = store.compact()
    survivors = [i for i in range(n_arch) if i not in dropped]
    bad += sum(not same_decode(store.container(f"ar{i}"), inline[i]) for i in survivors)
    stale_ok = 0
    for ref in old_refs.values():
        try:
            store.resolve(ref)
        except StaleSnapshotError:
            stale_ok += 1
    print(
        f"compact: dropped {rep['dropped']} entries "
        f"({rep['entries_before']} -> {rep['entries_after']}), rebased "
        f"{len(rep['rebased'])} containers, decode exact; "
        f"{stale_ok}/{len(old_refs)} retired refs typed stale"
    )
    bad += len(old_refs) - stale_ok

    with tempfile.TemporaryDirectory() as d:
        paths = store.spill(d)
        loaded = KBStore.load(d)
        kb_bad = 0
        for i in survivors:
            kb = loaded.container_kb(read_snapshot_ref(store.container(f"ar{i}")))
            if kb.canonical() != writers[i].kb.canonical():
                kb_bad += 1
        print(
            f"spill/load: {len(paths)} snapshot file(s), sem_id match: "
            f"{loaded.sem_id() == store.sem_id()}, "
            f"{len(survivors) - kb_bad}/{len(survivors)} KB views exact"
        )
        bad += kb_bad + (loaded.sem_id() != store.sem_id())

    print(f"mismatches: {bad}" + ("" if bad == 0 else "  <-- FAIL"))
    return 0 if bad == 0 else 1


class _SimClock:
    """Deterministic clock for quota and deadline decisions: the sim
    advances it a fixed step a tick, so admission replays from the seed
    (wall latencies are measured apart with ``perf_counter``)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _gen_traffic(series: int, ticks: int, seed: int):
    """Poisson sensor mix: per-series arrival probability and mean chunk
    size span an order of magnitude; each chunk continues that series'
    random walk.  Returns (per-tick [(sid, chunk)], full history)."""
    rng = np.random.default_rng(seed)
    rates = 10.0 ** rng.uniform(-0.8, 0.0, size=series)
    means = rng.integers(24, 160, size=series)
    last = np.zeros(series)
    traffic, history = [], {i: [] for i in range(series)}
    for _ in range(ticks):
        tick = []
        for sid in range(series):
            if rng.random() < rates[sid]:
                m = 1 + int(rng.poisson(means[sid]))
                chunk = np.round(last[sid] + np.cumsum(rng.standard_normal(m) * 0.05), 4)
                last[sid] = chunk[-1]
                tick.append((sid, chunk))
                history[sid].append(chunk)
        traffic.append(tick)
    return traffic, history


def _pcts(ms: list[float]) -> dict:
    if not ms:
        return {"p50_ms": 0.0, "p99_ms": 0.0}
    a = np.asarray(ms)
    return {"p50_ms": float(np.percentile(a, 50)), "p99_ms": float(np.percentile(a, 99))}


def _ingest_fleet(traffic, n_shards: int, flush_samples: int, tick_dt: float = 0.01,
                  device: torch.device | str | None = None):
    """Drive one fleet through the traffic, attributing each submit's wall
    time to the owning shard: the reference's critical-path model, in
    which the shards would run side by side and the aggregate rate is the
    total bytes over the busiest shard's time.  On one card the shards
    share the device and run one after another on the host."""
    clk = _SimClock()
    # four tenants round-robin over series; t3 runs on a tight bucket so
    # the quota rejection and shed paths run deterministically
    quotas = {
        f"t{k}": TenantQuota(rate_per_s=4e6, burst=4e6, clock=clk) for k in range(3)
    }
    quotas["t3"] = TenantQuota(rate_per_s=2_000.0, burst=3_000.0, clock=clk)
    fleet = ShrinkFleet(
        ShrinkConfig(eps_b=0.4, lam=1e-4),
        eps_targets=[8e-3],
        n_shards=n_shards,
        flush_samples=flush_samples,
        tenant_of=lambda sid: f"t{sid % 4}",
        quotas=quotas,
        clock=clk,
        device=device,
    )
    busy = [0.0] * n_shards
    lat_ms, admitted, rejected = [], {}, 0
    for tick in traffic:
        for sid, chunk in tick:
            shard = fleet.shard_of(sid)
            t0 = time.perf_counter()
            try:
                fleet.submit(sid, chunk)
            except QuotaExceededError:
                rejected += 1
                continue
            finally:
                dt = time.perf_counter() - t0
                busy[shard] += dt
            lat_ms.append(dt * 1e3)
            admitted.setdefault(sid, []).append(chunk)
        clk.t += tick_dt
        fleet.poll()
    # each shard pays for compressing its own residual pending pool
    # (finalize is idempotent, so fleet.seal() reuses these containers)
    for i, b in enumerate(fleet.batchers):
        t0 = time.perf_counter()
        b.finalize()
        busy[i] += time.perf_counter() - t0
    fleet.seal()
    return fleet, busy, lat_ms, admitted, rejected


def run_fleet_sim(
    n_shards: int = 4,
    series: int = 32,
    ticks: int = 120,
    queries: int = 192,
    flush_samples: int = 2048,
    seed: int = 0,
    check: bool = True,
    kill: bool = True,
    device: torch.device | str | None = None,
) -> dict:
    """The fleet simulation behind ``--mode fleet``: Poisson mixed traffic
    through a sharded multi-tenant fleet on ``device`` (default the card),
    p50/p99 ingest and query latency, the critical-path aggregate MB/s,
    the cross-shard check against the 1-shard oracle (``check``) and a
    shard-kill tail (``kill``).  Everything is seeded; the returned
    ``silent`` and ``byte_mismatch`` must be zero."""
    eps = 8e-3
    traffic, _ = _gen_traffic(series, ticks, seed)
    fleet, busy, ingest_ms, admitted, rejected = _ingest_fleet(
        traffic, n_shards, flush_samples, device=device
    )
    full = {sid: np.concatenate(cs) for sid, cs in admitted.items()}
    samples = sum(v.size for v in full.values())
    mb = samples * BYTES_PER_ROW / 1e6
    critical = max(busy) if busy else 1e-12

    def check_range(q, tally) -> None:
        if q.error is not None:
            tally["error"] += 1
            return
        err = float(np.abs(q.result.cpu().numpy() - full[q.series_id][q.t0 : q.t1]).max())
        if err > max(q.achieved, q.eps) * (1 + 1e-9):
            tally["SILENT"] += 1
        else:
            tally["degraded" if q.degraded else "ok"] += 1

    # mixed queries: 70% range / 20% aggregate / 10% threshold count
    qrng = np.random.default_rng(seed + 1)
    sids = sorted(s for s, v in full.items() if v.size >= 16)
    tally = {"ok": 0, "degraded": 0, "error": 0, "SILENT": 0}
    query_ms = []
    for qid in range(queries):
        sid = int(qrng.choice(sids))
        n = full[sid].size
        lo = int(qrng.integers(0, n - 8))
        hi = int(min(n, lo + 8 + qrng.integers(0, 4096)))
        kind = qid % 10
        t0 = time.perf_counter()
        if kind < 7:
            q = fleet.query(RangeQuery(qid=qid, series_id=sid, t0=lo, t1=hi, eps=eps))
            # the answer is assembled on the device: wait for it before the clock
            _sync(fleet.plan.device_of(fleet.shard_of(sid)))
            query_ms.append((time.perf_counter() - t0) * 1e3)
            check_range(q, tally)
            continue
        sl = full[sid][lo:hi]
        if kind < 9:
            ans = fleet.aggregate(sid, ("sum", "min")[kind % 2], lo, hi, eps=eps)
            truth = float(sl.sum() if kind % 2 == 0 else sl.min())
        else:
            c = float(qrng.uniform(sl.min(), sl.max() + 1e-9))
            ans = fleet.count_where(sid, "gt", c, lo, hi, eps=None)
            truth = float((sl > c).sum())
        query_ms.append((time.perf_counter() - t0) * 1e3)
        if ans.lo - 1e-9 <= truth <= ans.hi + 1e-9:
            tally["degraded" if ans.degraded else "ok"] += 1
        else:
            tally["SILENT"] += 1

    # cross-shard check: every series' frames byte-identical to the
    # 1-shard oracle built from the same traffic
    byte_mismatch = 0
    if check and n_shards > 1:
        oracle, _, _, _, _ = _ingest_fleet(traffic, 1, flush_samples, device=device)
        for sid in sorted(full):
            if fleet.series_frames(sid) != oracle.series_frames(sid):
                byte_mismatch += 1
        if fleet.global_kb.canonical() != oracle.global_kb.canonical():
            byte_mismatch += 1

    # shard-kill tail: corrupt one shard; the healthy shards must stay
    # exact and the dead shard's answers typed or flagged, never silent
    kill_tally = {"ok": 0, "degraded": 0, "error": 0, "SILENT": 0}
    fault_detail = ""
    if kill and n_shards > 1:
        chaos = ChaosInjector(seed=seed + 7)
        fault = chaos.kill_shard(fleet, shard=0, mode="corrupt")
        fault_detail = fault.detail
        for qid in range(min(queries, 64)):
            sid = int(qrng.choice(sids))
            n = full[sid].size
            lo = int(qrng.integers(0, n - 8))
            hi = int(min(n, lo + 8 + qrng.integers(0, 2048)))
            q = fleet.query(
                RangeQuery(qid=10_000 + qid, series_id=sid, t0=lo, t1=hi, eps=eps)
            )
            check_range(q, kill_tally)

    st = fleet.fleet_stats()
    return {
        "n_shards": n_shards,
        "series": series,
        "samples": samples,
        "mb": mb,
        "ingest": {
            "chunks": len(ingest_ms),
            "rejected_quota": rejected,
            "busy_s": [round(b, 4) for b in busy],
            "critical_path_s": critical,
            "agg_mb_s": mb / critical,
            **_pcts(ingest_ms),
        },
        "query": {"count": queries, **_pcts(query_ms), **tally},
        "kill": {"fault": fault_detail, **kill_tally},
        "kb": {
            "syncs": st["kb_syncs"],
            "global_entries": fleet.global_kb.epoch,
            "semantic_id": fleet.global_kb.snapshot_id(),
        },
        "byte_mismatch": byte_mismatch,
        "silent": tally["SILENT"] + kill_tally["SILENT"],
    }


def _serve_fleet(args, dev: torch.device) -> int:
    """Sharded fleet simulation (:func:`run_fleet_sim`): prints the latency
    and throughput summary; fails on any silent corruption or cross-shard
    byte divergence."""
    scale = 0.25 if args.quick else 1.0
    r = run_fleet_sim(
        n_shards=args.shards,
        series=max(8, int(args.series * 4 * scale)),
        ticks=max(30, int(args.ticks * scale)),
        queries=max(48, int(args.queries * scale)),
        flush_samples=args.flush_samples,
        seed=args.chaos_seed,
        device=dev,
    )
    ing, q, k = r["ingest"], r["query"], r["kill"]
    print(
        f"fleet: {r['n_shards']} shards, {r['series']} series, "
        f"{r['samples']:,} samples ({r['mb']:.1f} MB), "
        f"{ing['chunks']} chunks admitted, {ing['rejected_quota']} quota-rejected"
    )
    print(
        f"ingest: p50={ing['p50_ms']:.2f}ms p99={ing['p99_ms']:.2f}ms, "
        f"critical path {ing['critical_path_s']:.2f}s -> {ing['agg_mb_s']:.1f} MB/s "
        f"aggregate (busy per shard: {ing['busy_s']})"
    )
    print(
        f"query: {q['count']} mixed (range/aggregate/count) "
        f"p50={q['p50_ms']:.2f}ms p99={q['p99_ms']:.2f}ms — "
        f"{q['ok']} ok, {q['degraded']} degraded, {q['error']} typed errors, "
        f"{q['SILENT']} SILENT"
    )
    if k["fault"]:
        print(
            f"shard-kill [{k['fault']}]: {k['ok']} ok, {k['degraded']} degraded, "
            f"{k['error']} typed errors, {k['SILENT']} SILENT"
        )
    print(
        f"kb: {r['kb']['syncs']} syncs, {r['kb']['global_entries']} global entries; "
        f"cross-shard diff vs 1-shard oracle: {r['byte_mismatch']} mismatches"
    )
    bad = r["silent"] + r["byte_mismatch"]
    print(f"silent corruptions + byte mismatches: {bad}" + ("" if bad == 0 else "  <-- FAIL"))
    return 0 if bad == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--mode",
        choices=["model", "range", "ingest", "analytics", "chaos", "fleet", "kbstore"],
        default="model",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # model mode
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    # range, analytics and chaos modes
    ap.add_argument("--series", type=int, default=8)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--frame-len", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--eps", type=float, default=1e-3, help="fraction of value range")
    ap.add_argument("--cache-frames", type=int, default=32)
    # ingest mode
    ap.add_argument("--ticks", type=int, default=100, help="gateway polling rounds")
    ap.add_argument("--flush-samples", type=int, default=131_072)
    ap.add_argument("--flush-deadline", type=float, default=None)
    ap.add_argument("--buckets", type=int, default=4)
    ap.add_argument("--verify-queries", type=int, default=2)
    # chaos mode
    ap.add_argument("--fault-rate", type=float, default=0.01,
                    help="transient decode failure probability (phase 2)")
    ap.add_argument("--corruptions", type=int, default=48,
                    help="corrupt containers to generate (phase 1)")
    ap.add_argument("--queries-per-fault", type=int, default=8)
    ap.add_argument("--chaos-seed", type=int, default=0)
    # fleet mode
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="scaled-down fleet sim and KB-store corpus")
    args = ap.parse_args(argv)
    if args.mode == "model" and not args.arch:
        ap.error("--arch is required in --mode model")
    dev = resolve_device(args.device)
    modes = {
        "kbstore": _serve_kbstore,
        "fleet": _serve_fleet,
        "chaos": _serve_chaos,
        "ingest": _serve_ingest,
        "analytics": _serve_analytics,
        "range": _serve_range,
        "model": _serve_model,
    }
    return modes[args.mode](args, dev)


if __name__ == "__main__":
    sys.exit(main())
