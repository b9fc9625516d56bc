"""Parity of the port's compressed-domain analytics and range serving with
the reference, on the CPU.

* ``tests/golden/golden_analytics.json`` reproduced exactly by the port's
  ``SeriesAnalytics`` and ``AnalyticsEngine``;
* on seeded random-walk containers: every answer, the planner's ``stats``
  and the top-k and similarity records equal to the reference's;
* ``RangeQueryBatcher``: results, achieved bounds and ``stats`` equal,
  ``peek`` and the ``degraded_ok`` route included;
* ``python -m repro_torch.launch.serve --mode range|analytics --device
  cpu`` at a small size exits 0.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401
import numpy as np
import pytest

import repro.core as R
from repro.analytics import AnalyticsEngine as RefEngine
from repro.analytics import SeriesAnalytics as RefSeries
from repro.serving.batching import RangeQuery as RefQuery
from repro.serving.batching import RangeQueryBatcher as RefBatcher

import repro_torch.core as P
from repro_torch.analytics import AnalyticsEngine, SeriesAnalytics
from repro_torch.core import serialize as PZ
from repro_torch.launch import serve
from repro_torch.serving import RangeQuery, RangeQueryBatcher

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)

OPS = ("min", "max", "sum", "mean", "count", "stddev")


def _port_golden_analytics() -> dict:
    """``golden.build_analytics`` with the port's engines on the CPU."""
    v = golden.golden_series()
    sa = SeriesAnalytics(P.cs_from_bytes(golden.GOLDEN_PYRAMID.read_bytes()), device="cpu")
    tiers = golden.pyramid_tiers(v)
    out: dict = {"pyramid": {"tiers": tiers, "aggregate": {}, "count_where": {}}}
    for span_name, (t0, t1) in {"full": (0, golden.N), "mid": (100, 1100)}.items():
        for eps_name, eps in [("base", None)] + [(f"tier{i}", e) for i, e in enumerate(tiers)]:
            for op in OPS:
                key = f"{span_name}/{eps_name}/{op}"
                out["pyramid"]["aggregate"][key] = golden._ans(sa.aggregate(op, t0, t1, eps=eps))
    for op, q in (("gt", 0.75), ("le", 0.25)):
        c = float(np.quantile(v, q))
        for eps_name, eps in [("base", None), ("fine", tiers[2]), ("exact", 0.0)]:
            key = f"{op}/{eps_name}"
            out["pyramid"]["count_where"][key] = golden._ans(sa.count_where(op, c, eps=eps))
            out["pyramid"]["count_where"][key]["threshold"] = c
    out["pyramid"]["topk_length"] = sa.topk_segments(k=3, by="length")
    out["pyramid"]["topk_max"] = sa.topk_segments(k=2, by="max")
    eng = AnalyticsEngine(golden.GOLDEN_RAGGED.read_bytes(), device="cpu")
    ragged: dict = {"series": {}}
    for sid, arr in enumerate(golden.golden_ragged_series()):
        if arr.size == 0:
            continue
        rec: dict = {}
        for eps_name, eps in (("base", None), ("exact", 0.0)):
            for op in ("min", "max", "sum", "mean", "stddev"):
                rec[f"{eps_name}/{op}"] = golden._ans(eng.aggregate(sid, op, eps=eps))
        c = float(np.quantile(arr, 0.5))
        rec["gt_median"] = golden._ans(eng.count_where(sid, "gt", c, eps=0.0))
        rec["gt_median"]["threshold"] = c
        rec["topk_length"] = eng.topk_segments(sid, k=2, by="length")
        ragged["series"][str(sid)] = rec
    out["ragged"] = ragged
    return out


def test_golden_analytics_reproduced_exactly():
    want = json.loads(golden.GOLDEN_ANALYTICS.read_text())
    got = json.loads(json.dumps(_port_golden_analytics()))
    assert got == want


def _container(seed: int, s: int = 3, n: int = 6000, frame_len: int = 1024):
    v = serve.sensor_values(s, n, seed)
    vrng = float(v.max() - v.min())
    tiers = [1e-2 * vrng, 1e-3 * vrng, 0.0]
    sc = R.ShrinkStreamCodec(R.ShrinkConfig(eps_b=0.02 * vrng, lam=1e-4), tiers, decimals=4,
                             backend="rans", value_range=(float(v.min()), float(v.max())),
                             frame_len=frame_len)
    for c0 in range(0, n, 700):
        for sid in range(s):
            sc.ingest(v[sid, c0 : c0 + 700], series_id=sid)
    return v, tiers, sc.finalize()


def _queries(v, tiers, count: int, seed: int):
    """A seeded mix over every op, resolution and comparison."""
    rng = np.random.default_rng(seed)
    s, n = v.shape
    out = []
    for i in range(count):
        sid = int(rng.integers(0, s))
        lo = int(rng.integers(-50, n - 8))
        hi = int(min(n + 50, lo + rng.integers(8, 3500)))
        eps = [None, *tiers, 0.5 * tiers[1]][i % 5]
        if i % 3 == 2:
            cmp = ["gt", "ge", "lt", "le"][i % 4]
            c = float(rng.uniform(v[sid].min(), v[sid].max()))
            out.append(("count_where", sid, cmp, c, max(lo, 0), min(hi, n), eps))
        else:
            out.append(("aggregate", sid, OPS[i % 6], max(lo, 0), min(hi, n), eps))
    return out


def _answer(a) -> dict:
    return dataclasses.asdict(a)


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_answers_stats_and_topk_equal(seed):
    v, tiers, blob = _container(seed)
    ref = RefEngine(blob, cache_frames=4)
    port = AnalyticsEngine(blob, cache_frames=4, device="cpu")
    for q in _queries(v, tiers, 90, seed):
        got, want = getattr(port, q[0])(*q[1:-1], eps=q[-1]), getattr(ref, q[0])(*q[1:-1], eps=q[-1])
        assert _answer(got) == _answer(want), q
    assert port.stats == ref.stats
    assert port.batcher.stats == ref.batcher.stats
    for sid in range(v.shape[0]):
        for by in ("length", "slope", "abs_slope", "max", "min"):
            assert port.topk_segments(sid, k=4, by=by, t0=100, t1=5000) == \
                ref.topk_segments(sid, k=4, by=by, t0=100, t1=5000)
        assert port.similar_segments(sid, 0.01, 200.0, k=3) == \
            ref.similar_segments(sid, 0.01, 200.0, k=3)
        assert port.segments(sid) == ref.segments(sid)


def test_series_analytics_equal_on_a_random_walk():
    rng = np.random.default_rng(3)
    v = np.round(np.cumsum(rng.standard_normal(5000)) * 0.1, 4)
    vrng = float(v.max() - v.min())
    tiers = [1e-1 * vrng, 1e-2 * vrng, 1e-3 * vrng, 0.0]
    codec = R.ShrinkCodec.from_fraction(v, frac=0.05, backend="rans")
    blob = R.cs_to_bytes(codec.compress(v, tiers, decimals=4))
    ref, port = RefSeries(R.cs_from_bytes(blob)), SeriesAnalytics(P.cs_from_bytes(blob),
                                                                   device="cpu")
    for q in _queries(v[None], tiers, 120, 3):
        kind, _, *args = q
        got = getattr(port, kind)(*args[:-1], eps=args[-1])
        want = getattr(ref, kind)(*args[:-1], eps=args[-1])
        assert _answer(got) == _answer(want), q
    assert port.topk_segments(k=5, by="abs_slope") == ref.topk_segments(k=5, by="abs_slope")
    assert port.similar_segments(-0.02, 50.0, k=4) == ref.similar_segments(-0.02, 50.0, k=4)


def _range_pair(blob, **kw):
    return RefBatcher(blob, **kw), RangeQueryBatcher(blob, device="cpu", **kw)


def test_range_batcher_results_and_stats_equal():
    v, tiers, blob = _container(4)
    ref, port = _range_pair(blob, cache_frames=3)
    rng = np.random.default_rng(4)
    specs = []
    for qid in range(60):
        sid = int(rng.integers(0, 4))  # series 3 is unknown: a typed error
        t0 = int(rng.integers(-20, 5900))
        specs.append((qid, sid, t0, t0 + int(rng.integers(-3, 2500)),
                      [tiers[0], tiers[1], 0.0, 5e-3][qid % 4]))
    for batch in (specs[:25], specs[25:]):
        for args in batch:
            ref.submit(RefQuery(*args))
            port.submit(RangeQuery(*args))
        for w, g in zip(ref.run(), port.run()):
            assert (g.error is None) == (w.error is None), (g.error, w.error)
            assert (g.achieved, g.degraded) == (w.achieved, w.degraded)
            if w.error is None:
                assert np.array_equal(g.result.numpy(), w.result)
        # peek: served from cached prefixes only, or None when a frame is cold
        for args in specs[:30]:
            wq, gq = RefQuery(*args), RangeQuery(*args)
            w, g = ref.peek(wq), port.peek(gq)
            assert (g is None) == (w is None)
            if w is not None:
                assert np.array_equal(g.numpy(), w) and gq.achieved == wq.achieved
    assert port.stats == ref.stats
    assert 0 < port.stats["errors"] < port.stats["queries"] and port.stats["layer_hits"] > 0
    assert port.series_ids == ref.series_ids and port.span(1) == ref.span(1)


def test_degraded_ok_serves_the_same_intact_prefix():
    _, tiers, blob = _container(6, s=2, n=3000)
    metas, _ = PZ.parse_framed_container(blob)
    bad = bytearray(blob)
    m = metas[2]
    bad[m.offset + m.length - 5] ^= 0x33  # inside the frame's last pyramid layer
    bad = bytes(bad)
    for degraded_ok in (False, True):
        ref, port = _range_pair(bad, degraded_ok=degraded_ok)
        for args in ((0, m.series_id, m.t_lo + 3, m.t_hi - 3, 0.0),
                     (1, m.series_id, m.t_lo, m.t_hi, tiers[0])):
            ref.submit(RefQuery(*args))
            port.submit(RangeQuery(*args))
        for w, g in zip(ref.run(), port.run()):
            assert (g.error is None, g.achieved, g.degraded) == \
                (w.error is None, w.achieved, w.degraded)
            if w.error is None:
                assert np.array_equal(g.result.numpy(), w.result)
        assert port.stats == ref.stats
        assert port.stats["degraded"] == int(degraded_ok)  # else both queries error
        eng_r = RefEngine(bad, degraded_ok=degraded_ok)
        eng_p = AnalyticsEngine(bad, degraded_ok=degraded_ok, device="cpu")
        for op in ("sum", "min"):
            try:
                want = _answer(eng_r.aggregate(m.series_id, op, m.t_lo, m.t_hi, eps=0.0))
            except ValueError as e:
                want = type(e).__name__
            try:
                got = _answer(eng_p.aggregate(m.series_id, op, m.t_lo, m.t_hi, eps=0.0))
            except ValueError as e:
                got = type(e).__name__
            assert got == want, (degraded_ok, op)


@pytest.mark.parametrize("mode", ["range", "analytics"])
def test_serve_exits_zero_on_the_cpu(mode):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", mode, "--device", "cpu",
         "--series", "2", "--points", "4096", "--frame-len", "1024", "--chunk", "700",
         "--queries", "24"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "failed=0" in out.stdout
