"""Serving launcher of the port, counterpart of ``repro.launch.serve`` in
its model, range and analytics modes (the others wait for their slices):

    # LM decode loop (continuous batching) over a dense model at random init
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
        --requests 16 --slots 8 --max-new 8

    # time-series range queries against a freshly streamed SHRKS container
    PYTHONPATH=src python -m repro_torch.launch.serve --mode range \
        --series 8 --points 65536 --frame-len 8192 --queries 256

    # compressed-domain analytics: aggregates / threshold counts / top-k
    # straight off the container, differentially checked against numpy
    PYTHONPATH=src python -m repro_torch.launch.serve --mode analytics \
        --series 8 --points 65536 --frame-len 8192 --queries 256

All run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions) with the reference's seeded traffic and exit non-zero when
a check fails: every request served to its token budget, every range and
analytics answer within its bound of the raw values.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..analytics import AnalyticsEngine
from ..configs import get_config, reduced_config
from ..core import BYTES_PER_ROW, ShrinkConfig, ShrinkStreamCodec
from ..core.device import resolve_device
from ..models import build_model
from ..serving import ContinuousBatcher, RangeQuery, RangeQueryBatcher, Request

__all__ = ["analytics_traffic", "main", "range_traffic", "sensor_values"]

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
    """Continuous batching over a dense model at random init (seed 0): the
    reference's seeded prompts of 4-15 tokens, greedy decode, no EOS."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["model", "range", "analytics"], default="model")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # model mode
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    # range and analytics modes
    ap.add_argument("--series", type=int, default=8)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--frame-len", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--eps", type=float, default=1e-3, help="fraction of value range")
    ap.add_argument("--cache-frames", type=int, default=32)
    args = ap.parse_args(argv)
    if args.mode == "model" and not args.arch:
        ap.error("--arch is required in --mode model")
    dev = resolve_device(args.device)
    if args.mode == "analytics":
        return _serve_analytics(args, dev)
    if args.mode == "range":
        return _serve_range(args, dev)
    return _serve_model(args, dev)


if __name__ == "__main__":
    sys.exit(main())
