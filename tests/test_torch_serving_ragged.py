"""Parity of the port's ragged gateway ingest with the reference, on the CPU.

* ``data.synthetic``: ``ragged_sensor_traffic``, ``load`` and
  ``household_power`` give the reference's arrays;
* ``RaggedBatcher``: the container bytes, ``sealed_frames()`` and
  ``stats()`` equal the reference batcher's (never its per-series loop:
  the two disagree on signed zeros) in both scopes, with the size and the
  deadline triggers on a fake clock, an idempotent ``finalize``, a no-op
  flush after it, and empty and length-1 series;
* the golden ragged container rebuilt byte for byte;
* bad configurations raise the reference's typed errors.
"""
import importlib.util
import pathlib

import jax  # noqa: F401
import numpy as np
import pytest

import repro.core as R
from repro.data import synthetic as RD
from repro.serving.ragged import RaggedBatcher as RB

import repro_torch.core as P
from repro_torch.data import synthetic as PD
from repro_torch.serving.ragged import RaggedBatcher as PB

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("s,ticks,lo,hi,seed", [(7, 12, 2.0, 512.0, 0), (3, 40, 0.5, 4.0, 5)])
def test_ragged_sensor_traffic_equals_reference(s, ticks, lo, hi, seed):
    want = RD.ragged_sensor_traffic(s, ticks, rate_lo=lo, rate_hi=hi, seed=seed)
    got = PD.ragged_sensor_traffic(s, ticks, rate_lo=lo, rate_hi=hi, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [sid for sid, _ in g] == [sid for sid, _ in w]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(g, w))


@pytest.mark.parametrize("name", sorted(RD.DATASETS))
def test_load_equals_reference(name):
    assert np.array_equal(PD.load(name, n=3000), RD.load(name, n=3000))
    assert PD.DATASETS[name].rows == RD.DATASETS[name].rows
    assert PD.DATASETS[name].decimals == RD.DATASETS[name].decimals


def test_household_power_equals_reference():
    assert np.array_equal(PD.household_power(3, 5000), RD.household_power(3, 5000))


def _traffic(seed: int):
    """Short seeded ragged traffic, plus a length-1 chunk and an empty one
    each tick (both must pass through unchanged)."""
    traffic = RD.ragged_sensor_traffic(10, 24, rate_lo=1.0, rate_hi=40.0, seed=seed)
    for k, tick in enumerate(traffic):
        tick.append((100, np.round(np.array([0.25 * k]), 4)))
        tick.append((101, np.zeros(0)))
    return traffic


def _drive(mod, cfg_mod, scope, trigger, traffic, **kw):
    clk = FakeClock()
    if trigger == "size":
        kw.update(flush_samples=500 if scope == "batch" else 120, flush_deadline_s=None)
    else:
        kw.update(flush_samples=None, flush_deadline_s=0.035)
    b = mod(cfg_mod.ShrinkConfig(eps_b=0.4, lam=1e-4), eps_targets=[8e-3, 0.0], decimals=4,
            backend="rans", max_buckets=3, scope=scope, clock=clk, **kw)
    sealed = []
    for tick in traffic:
        for sid, chunk in tick:
            sealed.append(b.submit(sid, chunk))
        clk.t += 0.01
        sealed.append(b.poll())
    sealed.append(b.flush([0, 3, 999]))  # a subset, with an unknown id
    first = b.finalize()
    return b, first, sealed


@pytest.mark.parametrize("trigger", ["size", "deadline"])
@pytest.mark.parametrize("scope", ["batch", "series"])
def test_batcher_bytes_frames_and_stats_equal_reference(scope, trigger):
    traffic = _traffic(1)
    rb, want, r_sealed = _drive(RB, R, scope, trigger, traffic)
    pb, got, p_sealed = _drive(PB, P, scope, trigger, traffic, device="cpu")
    assert got == want
    assert p_sealed == r_sealed
    assert pb.sealed_frames == rb.sealed_frames
    assert pb.stats() == rb.stats()
    assert pb.stats()["flushes"] > 2  # the trigger fired during ingest
    # finalize is idempotent; after it a flush or a poll is a no-op and a
    # submit raises the reference's typed error
    assert pb.finalize() == want
    assert pb.flush() == [] and pb.poll() == [] and not pb.due() and pb.due_series() == []
    with pytest.raises(P.BatcherFinalizedError):
        pb.submit(0, [1.0])


def test_best_backend_and_shared_kb_equal_reference():
    """``best`` routes streams to several backends; two batchers share one
    knowledge base, as two gateways of one site would."""
    traffic = _traffic(2)
    out = []
    for mod, cm, kw in ((RB, R, {}), (PB, P, {"device": "cpu"})):
        cfg = cm.ShrinkConfig(eps_b=0.3, lam=1e-4)
        a = mod(cfg, eps_targets=[0.05, 0.0], decimals=4, backend="best", flush_samples=400, **kw)
        b = mod(cfg, eps_targets=[0.05], backend="rans", flush_samples=300, kb=a.kb, **kw)
        for tick in traffic:
            for sid, chunk in tick:
                (a if sid % 2 else b).submit(sid, chunk)
        out.append((a.finalize(), b.finalize(), a.stats(), b.stats()))
    assert out[1] == out[0]


def test_golden_ragged_container_rebuilt_byte_for_byte():
    series = golden.golden_ragged_series()
    allv = np.concatenate(series)
    b = PB(P.ShrinkConfig(eps_b=0.05 * float(allv.max() - allv.min()), lam=1e-3),
           eps_targets=golden.EPS_TARGETS, decimals=golden.DECIMALS, backend="rans",
           flush_samples=None, max_buckets=3, device="cpu")
    for sid, v in enumerate(series):
        b.submit(sid, v[: (2 * v.size) // 3])
    b.flush()
    for sid, v in enumerate(series):
        b.submit(sid, v[(2 * v.size) // 3 :])
    assert b.finalize() == golden.GOLDEN_RAGGED.read_bytes()


@pytest.mark.parametrize("kw", [
    dict(eps_targets=[0.0]),
    dict(flush_samples=0),
    dict(flush_deadline_s=-1.0),
    dict(scope="tick"),
    dict(inline_kb=False),
])
def test_bad_configurations_raise_the_reference_errors(kw):
    args = {"eps_targets": [1e-2], **kw}
    with pytest.raises(R.ShrinkError) as want:
        RB(R.ShrinkConfig(eps_b=0.1), **args)
    with pytest.raises(P.ShrinkError) as got:
        PB(P.ShrinkConfig(eps_b=0.1), **args, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_batcher_defaults_to_the_card():
    with pytest.raises(P.ConfigError, match="CUDA"):
        PB(P.ShrinkConfig(eps_b=0.1), eps_targets=[1e-2])
