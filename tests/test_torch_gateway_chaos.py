"""Parity of the port's chaos tooling and fault-tolerant gateway with the
reference, on the CPU.

* every mutator (``flip_byte``, ``truncate``, ``smash_frame_crc``,
  ``drop_frame``, ``stale_snapshot_ref``) gives the reference's mutant
  bytes and ``Fault``; ``list_frames`` the same directory;
* ``ChaosInjector(seed)`` draws the same faults in the same order, and
  ``FlakyCallable`` fails on the same calls;
* ``RetryPolicy`` jitter and ``CircuitBreaker`` transitions on a fake clock;
* ``FaultTolerantGateway`` on a fake clock and sleep, with a flaky decode
  step, a tiny queue and deadlines: every answer's values (bits),
  ``achieved``, ``degraded`` and typed error, the sleeps and ``stats``
  equal the reference's; likewise over corrupt containers;
* ``serve --mode chaos``: the tallies of phases 1 and 3 equal the
  reference launcher's (phase 2 runs on the real clock).
"""
import contextlib
import dataclasses
import io
import random
import re

import jax  # noqa: F401
import numpy as np
import pytest

import repro.core as R
from repro.launch import serve as RServe
from repro.serving import gateway as RG
from repro.serving.batching import RangeQuery as RQ
from repro.testing import chaos as RC

from repro_torch.launch import serve as PServe
from repro_torch.serving import gateway as PG
from repro_torch.serving.batching import RangeQuery as PQ
from repro_torch.testing import chaos as PC


def _container(with_store: bool = False) -> tuple[np.ndarray, bytes]:
    from repro.serving.kbstore import KBStore

    rng = np.random.default_rng(4)
    v = np.round(np.cumsum(rng.standard_normal((3, 1800)) * 0.05, axis=1), 4)
    cfg = R.ShrinkConfig(eps_b=0.05 * float(v.max() - v.min()), lam=1e-4)
    store = KBStore(cfg) if with_store else None
    sc = R.ShrinkStreamCodec(cfg, eps_targets=[1e-2, 1e-3, 0.0], decimals=4, backend="rans",
                             value_range=(float(v.min()), float(v.max())), frame_len=400,
                             kb_store=store, inline_kb=True if store is not None else None)
    for sid in range(3):
        sc.ingest(v[sid], series_id=sid)
    return v, sc.finalize()


_, BLOB = _container()


def _fault(f) -> tuple:
    return dataclasses.astuple(f)


def _same_mutation(rfn, pfn, *args):
    rb, rf = rfn(*args)
    pb, pf = pfn(*args)
    assert pb == rb and _fault(pf) == _fault(rf)


@pytest.mark.parametrize("offset,bit", [(0, 0), (17, 3), (len(BLOB) - 1, 7), (500, 11)])
def test_flip_byte_equals_reference(offset, bit):
    _same_mutation(RC.flip_byte, PC.flip_byte, BLOB, offset, bit)


@pytest.mark.parametrize("keep", [0, 5, len(BLOB) // 2, len(BLOB), len(BLOB) + 9, -3])
def test_truncate_equals_reference(keep):
    _same_mutation(RC.truncate, PC.truncate, BLOB, keep)


def test_frame_mutators_and_directory_equal_reference():
    metas = RC.list_frames(BLOB)
    assert [dataclasses.astuple(m) for m in PC.list_frames(BLOB)] == [
        dataclasses.astuple(m) for m in metas]
    for i in range(len(metas)):
        _same_mutation(RC.smash_frame_crc, PC.smash_frame_crc, BLOB, i)
        _same_mutation(RC.drop_frame, PC.drop_frame, BLOB, i)
    for fn in (PC.smash_frame_crc, PC.drop_frame):
        with pytest.raises(IndexError):
            fn(BLOB, len(metas))
    with pytest.raises(IndexError):
        PC.flip_byte(BLOB, len(BLOB))


def test_stale_snapshot_ref_equals_reference():
    _, ref_blob = _container(with_store=True)
    _same_mutation(RC.stale_snapshot_ref, PC.stale_snapshot_ref, ref_blob)
    errs = []
    for mod in (RC, PC):
        with pytest.raises(ValueError) as e:
            mod.stale_snapshot_ref(BLOB)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kinds", [None, ("crc_smash", "frame_drop")])
def test_chaos_injector_draws_the_same_faults(seed, kinds):
    ri, pi = RC.ChaosInjector(seed), PC.ChaosInjector(seed)
    for blob in [BLOB] * 12 + [b"not a container" * 3]:
        rb, rf = ri.corrupt(blob, kinds)
        pb, pf = pi.corrupt(blob, kinds)
        assert pb == rb and _fault(pf) == _fault(rf)
    rfl, pfl = ri.flaky(lambda: 1, 0.5), pi.flaky(lambda: 1, 0.5)
    assert pfl.rng.getstate() == rfl.rng.getstate()


def _outcomes(flaky, n: int) -> list:
    out = []
    for _ in range(n):
        try:
            out.append(flaky())
        except ValueError as e:  # TransientError, in either taxonomy
            out.append(type(e).__name__ + ": " + str(e))
    return out


def test_flaky_callable_fails_on_the_same_calls():
    sleeps = ([], [])
    r = RC.FlakyCallable(lambda: "ok", fail_rate=0.3, seed=5, slow_s=0.25, sleep=sleeps[0].append)
    p = PC.FlakyCallable(lambda: "ok", fail_rate=0.3, seed=5, slow_s=0.25, sleep=sleeps[1].append)
    assert _outcomes(p, 60) == _outcomes(r, 60)
    assert (p.calls, p.failures, sleeps[1]) == (r.calls, r.failures, sleeps[0])
    with pytest.raises(ValueError):
        PC.FlakyCallable(lambda: 0, fail_rate=1.5)


def test_retry_policy_and_breaker_equal_reference():
    rr, pr = random.Random(3), random.Random(3)
    for pol in ({}, dict(base_delay_s=0.01, multiplier=3.0, max_delay_s=0.05, jitter=0.5)):
        rp, pp = RG.RetryPolicy(**pol), PG.RetryPolicy(**pol)
        assert [pp.delay_s(k, pr) for k in range(8)] == [rp.delay_s(k, rr) for k in range(8)]
    clocks = [[0.0], [0.0]]
    rb = RG.CircuitBreaker(2, 5.0, clock=lambda: clocks[0][0])
    pb = PG.CircuitBreaker(2, 5.0, clock=lambda: clocks[1][0])
    trace = ([], [])
    for step in range(40):
        for br, clk, tr in ((rb, clocks[0], trace[0]), (pb, clocks[1], trace[1])):
            key = step % 3
            tr.append((br.allow(key), br.is_open(key)))
            (br.record_failure if step % 5 < 3 else br.record_success)(key)
            clk[0] += 0.7
    assert trace[1] == trace[0]
    with pytest.raises(ValueError):
        PG.CircuitBreaker(0)


class FakeTime:
    def __init__(self):
        self.t = 0.0
        self.slept = []

    def clock(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.slept.append(s)
        self.t += s


def _answer(q) -> tuple:
    vals = None if q.result is None else np.asarray(
        q.result.cpu().numpy() if hasattr(q.result, "cpu") else q.result).view(np.int64).tolist()
    return (q.qid, q.eps, vals, q.achieved, q.degraded, q.error)


def _serve(gmod, qmod, blob, fail_rate: float, dev: dict, coarse_eps=0.5, max_queue: int = 5):
    ft = FakeTime()
    gw = gmod.FaultTolerantGateway(
        blob, retry=gmod.RetryPolicy(max_attempts=3, base_delay_s=0.02),
        breaker=gmod.CircuitBreaker(failure_threshold=2, recovery_s=0.5, clock=ft.clock),
        max_queue=max_queue, coarse_eps=coarse_eps, cache_frames=3, clock=ft.clock, sleep=ft.sleep,
        seed=11, **dev)
    chaos = (RC if gmod is RG else PC).ChaosInjector(2)
    gw.frame_decode = chaos.flaky(gw.frame_decode, fail_rate, slow_s=0.01, sleep=ft.sleep)
    qrng = np.random.default_rng(3)
    done = []
    for qid in range(40):
        sid = int(qrng.integers(0, 4))  # series 3 does not exist
        lo = int(qrng.integers(0, 1700))
        hi = int(min(1900, lo + qrng.integers(1, 900)))  # past the end at times
        eps = float((1e-2, 1e-3, 0.0, 2.0)[qid % 4])
        try:
            gw.submit(qmod(qid=qid, series_id=sid, t0=lo, t1=hi, eps=eps))
        except ValueError as e:  # BackpressureError without a coarse tier
            done.append(type(e).__name__ + ": " + str(e))
        if len(gw.queue) >= max_queue + 3 or (coarse_eps is None and qid % 7 == 6):
            done += gw.run(deadline_s=0.12)
    done += gw.run(deadline_s=0.12)
    return ([q if isinstance(q, str) else _answer(q) for q in done], gw.stats, ft.slept,
            gw.batcher.stats)


@pytest.mark.parametrize("fail_rate,coarse_eps", [(0.0, 0.5), (0.3, 0.5), (0.9, 0.5),
                                                  (0.3, None)])
def test_gateway_answers_and_stats_equal_reference(fail_rate, coarse_eps):
    want = _serve(RG, RQ, BLOB, fail_rate, {}, coarse_eps)
    got = _serve(PG, PQ, BLOB, fail_rate, {"device": "cpu"}, coarse_eps)
    assert got == want
    st = got[1]
    if fail_rate:
        assert st["retries"] and st["breaker_opens"]
    assert st["errors"] and (st["shed"] if coarse_eps else st["rejected"])


@pytest.mark.parametrize("seed", [0, 3])
def test_gateway_over_corrupt_containers_equals_reference(seed):
    ri, pi = RC.ChaosInjector(seed), PC.ChaosInjector(seed)
    for _ in range(6):
        mutant, _ = ri.corrupt(BLOB)
        assert pi.corrupt(BLOB)[0] == mutant
        outs = []
        for gmod, qmod, dev in ((RG, RQ, {}), (PG, PQ, {"device": "cpu"})):
            try:
                outs.append(_serve(gmod, qmod, mutant, 0.0, dev))
            except ValueError as e:  # rejected at parse: typed in both
                outs.append((type(e).__name__, str(e)))
        assert outs[1] == outs[0]


def _tallies(main, argv) -> list[str]:
    """The launcher's phase 1 and phase 3 lines, times taken out."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("phase 1", "phase 3",
                                                                         "pristine"))]
    return [re.sub(r" in [\d.]+s", "", ln) for ln in lines]


def test_serve_chaos_tallies_equal_reference():
    argv = ["--mode", "chaos", "--series", "3", "--points", "3000", "--frame-len", "600",
            "--corruptions", "12", "--queries", "40", "--chaos-seed", "2"]
    want = _tallies(RServe.main, argv)
    assert _tallies(PServe.main, argv + ["--device", "cpu"]) == want
    assert len(want) == 3
