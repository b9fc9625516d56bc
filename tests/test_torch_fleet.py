"""Parity of the port's sharded serving fleet with the reference, on the CPU.

* ``shard_of`` for 10^4 ids and several shard counts; ``plan_fleet`` with
  a map and a callable assignment; ``describe()`` keys;
* a fleet driven through seeded Poisson traffic with tenant quotas on a
  fake clock, for 1 and 4 shards and a hostile assignment: every shard
  blob byte-identical to the reference fleet's, ``routing()``,
  ``fleet_stats()``, the KB sync records, the KB store it gossips into;
* queries through the fleet (range, quota-shed aggregates, ``count_where``,
  top-k, ``decode_range``, ``enqueue``/``run``), then a shard kill: the
  same answers, errors and stats;
* ``run_fleet_sim`` at a small size: the reference's counts, tallies and
  KB ids (its latencies and rates are host timings and are left out).
"""
import dataclasses

import jax  # noqa: F401
import numpy as np
import pytest

import repro.core as R
from repro.launch import serve as RServe
from repro.parallel import fleet as RPF
from repro.serving import fleet as RF
from repro.serving.batching import RangeQuery as RQ
from repro.serving.kbstore import KBStore as RStore
from repro.testing import chaos as RC

import repro_torch.core as P
from repro_torch.launch import serve as PServe
from repro_torch.parallel import fleet as PPF
from repro_torch.serving import fleet as PF
from repro_torch.serving.batching import RangeQuery as PQ
from repro_torch.serving.kbstore import KBStore as PStore
from repro_torch.testing import chaos as PC

SIDES = {
    "ref": dict(core=R, fleet=RF, q=RQ, store=RStore, chaos=RC, dev={}),
    "port": dict(core=P, fleet=PF, q=PQ, store=PStore, chaos=PC, dev={"device": "cpu"}),
}
TRAFFIC, _ = RServe._gen_traffic(12, 40, seed=3)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 64])
def test_shard_of_equals_reference(n):
    ids = list(range(10_000)) + [2**40 + 5, 2**63 - 1]
    assert [PPF.shard_of(i, n) for i in ids] == [RPF.shard_of(i, n) for i in ids]


def test_plan_fleet_equals_reference():
    ids = range(500)
    for assignment in (None, {3: 0, 4: 0, 10**6: 2}, lambda sid: (sid * 7) % 3):
        rp, pp = RPF.plan_fleet(3, assignment), PPF.plan_fleet(3, assignment, device="cpu")
        assert [pp.shard_of(i) for i in ids] == [rp.shard_of(i) for i in ids]
        rd, pd = rp.describe(), pp.describe()
        assert sorted(pd) == sorted(rd)
        assert (pd["n_shards"], pd["mesh_devices"], len(pd["devices"])) == (
            rd["n_shards"], rd["mesh_devices"], len(rd["devices"]))
        assert pd["devices"] == ["cpu"] * 3
    for mod, kw in ((RPF, {}), (PPF, {"device": "cpu"})):
        with pytest.raises(ValueError, match="outside"):
            mod.plan_fleet(2, lambda sid: 5, **kw).shard_of(1)
        with pytest.raises(ValueError):
            mod.plan_fleet(0, **kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _fleet(side: str, n_shards: int, assignment=None, with_store: bool = False):
    """A fleet through TRAFFIC: four tenants, the last on a tight bucket
    so that ingest is refused and queries shed; a KB sync every 3 flushes."""
    s = SIDES[side]
    clk = FakeClock()
    quotas = {f"t{k}": s["fleet"].TenantQuota(4e6, 4e6, clock=clk) for k in range(3)}
    quotas["t3"] = s["fleet"].TenantQuota(rate_per_s=600.0, burst=900.0, clock=clk)
    cfg = s["core"].ShrinkConfig(eps_b=0.4, lam=1e-4)
    store = s["store"](cfg) if with_store else None
    fleet = s["fleet"].ShrinkFleet(
        cfg, eps_targets=[8e-3, 1e-3], n_shards=n_shards, flush_samples=512,
        assignment=assignment, tenant_of=lambda sid: f"t{sid % 4}", quotas=quotas,
        kb_sync_every=3, kb_store=store, max_queue=4, cache_frames=4, clock=clk, seed=5,
        **s["dev"])
    refused = []
    for tick in TRAFFIC:
        for sid, chunk in tick:
            try:
                fleet.submit(sid, chunk)
            except ValueError as e:  # QuotaExceededError
                refused.append((sid, type(e).__name__, str(e)))
        clk.t += 0.01
        fleet.poll()
    fleet.seal()
    return fleet, refused, store, clk


def _gw_stats(fleet) -> list:
    return [None if g is None else dict(g) for g in fleet.fleet_stats()["gateways"]]


HOSTILE = {sid: 3 for sid in range(0, 12, 2)}  # half the series on one shard


@pytest.mark.parametrize("n_shards,assignment", [(1, None), (4, None), (4, HOSTILE)])
def test_fleet_blobs_routing_and_stats_equal_reference(n_shards, assignment):
    (rf, r_ref, rs, _), (pf, p_ref, ps, _) = (_fleet(s, n_shards, assignment, True) for s in SIDES)
    assert pf.seal() == rf.seal()
    assert p_ref == r_ref and r_ref  # the tight tenant was refused
    assert pf.routing() == rf.routing()
    assert pf.kb_syncs == rf.kb_syncs and len(rf.kb_syncs) > 2
    assert pf.fleet_stats() == rf.fleet_stats()
    assert pf.global_kb.to_bytes() == rf.global_kb.to_bytes()
    assert ps.stats() == rs.stats() and ps.sem_id() == rs.sem_id()
    for sid in range(12):
        assert pf.series_frames(sid) == rf.series_frames(sid)
    if n_shards == 4:  # sharding is invisible: the frames equal the 1-shard fleet's
        one, _, _, _ = _fleet("port", 1)
        assert all(pf.series_frames(sid) == one.series_frames(sid) for sid in range(12))


def _bits(x) -> list | None:
    if x is None:
        return None
    a = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return a.view(np.int64).tolist()


def _queries(side: str, fleet, clk) -> list:
    """Mixed queries, then a shard kill and more queries; every outcome
    as comparable plain data."""
    s = SIDES[side]
    out = []
    qrng = np.random.default_rng(8)
    for qid in range(36):
        sid = int(qrng.integers(0, 13))  # 12 has no frames
        lo = int(qrng.integers(0, 700))
        hi = int(lo + qrng.integers(1, 500))
        kind = qid % 6
        clk.t += 0.05
        try:
            if kind < 3:
                q = fleet.query(s["q"](qid=qid, series_id=sid, t0=lo, t1=hi,
                                       eps=(8e-3, 1e-3, 0.05)[kind]))
                out.append((q.error, q.achieved, q.degraded, _bits(q.result)))
            elif kind == 3:
                a = fleet.aggregate(sid, ("sum", "min", "stddev")[qid % 3], lo, hi, eps=8e-3)
                out.append(dataclasses.astuple(a))
            elif kind == 4:
                a = fleet.count_where(sid, "gt", float(qrng.uniform(-1, 1)), lo, hi, eps=0.0)
                out.append(dataclasses.astuple(a))
            else:
                out.append(fleet.topk_segments(sid, k=3))
                out.append(_bits(fleet.decode_range(sid, lo, min(hi, lo + 40), 1e-3)))
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    for qid in range(8):  # the queue: bounded admission, shed to coarse
        fleet.enqueue(s["q"](qid=100 + qid, series_id=1, t0=qid, t1=qid + 300, eps=1e-3))
    out.append([(q.qid, q.error, q.achieved, q.degraded, _bits(q.result)) for q in fleet.run()])
    out.append(dataclasses.astuple(s["chaos"].ChaosInjector(4).kill_shard(fleet)))
    for qid in range(16):
        q = fleet.query(s["q"](qid=200 + qid, series_id=qid % 12, t0=10, t1=700, eps=8e-3))
        out.append((q.error, q.achieved, q.degraded, _bits(q.result)))
    out.append((fleet.shards_down(), fleet.stats, _gw_stats(fleet)))
    return out


def test_fleet_queries_and_shard_kill_equal_reference():
    outs = []
    for side in SIDES:
        fleet, _, _, clk = _fleet(side, 4)
        outs.append(_queries(side, fleet, clk))
    assert outs[1] == outs[0]


def test_quota_bucket_equals_reference():
    clocks = [[0.0], [0.0]]
    rq = RF.TenantQuota(100.0, 250.0, clock=lambda: clocks[0][0])
    pq = PF.TenantQuota(100.0, 250.0, clock=lambda: clocks[1][0])
    trace = ([], [])
    for k in range(60):
        for tq, clk, tr in ((rq, clocks[0], trace[0]), (pq, clocks[1], trace[1])):
            tr.append((tq.try_take(float(k * 7 % 90)), tq.available()))
            clk[0] += 0.13
    assert trace[1] == trace[0]
    for mod in (RF, PF):
        with pytest.raises(ValueError):
            mod.TenantQuota(-1.0, 5.0)
        with pytest.raises(ValueError):
            mod.TenantQuota(1.0, 0.0)


TIMING = {"busy_s", "critical_path_s", "agg_mb_s", "p50_ms", "p99_ms"}


def _untimed(r: dict) -> dict:
    return {k: (_untimed(v) if isinstance(v, dict) else v) for k, v in r.items()
            if k not in TIMING}


def test_run_fleet_sim_equals_reference():
    kw = dict(n_shards=3, series=10, ticks=36, queries=48, flush_samples=768, seed=2)
    want = _untimed(RServe.run_fleet_sim(**kw))
    got = _untimed(PServe.run_fleet_sim(**kw, device="cpu"))
    assert got == want
    assert got["silent"] == 0 and got["byte_mismatch"] == 0 and got["kill"]["fault"]
