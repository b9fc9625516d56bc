"""Deterministic synthetic analogues of the paper's nine evaluation series,
the port's copy of ``repro.data.synthetic`` (pure numpy; the same seeds
give the same arrays in both packages).

Each generator is matched to Table II's published statistics (rows, value
range, decimal places) and to the structure the paper describes (ECG
periodicity, WindSpeed/WindDirection discontinuities on a 2-decimal grid,
Pressure drift with recurring patterns, Wafer plateaus, Lightning bursts).

``load(name, n=None)`` returns float64 values rounded to the dataset's
decimal count; ``n=None`` uses the full Table II row count.
``ragged_sensor_traffic`` is the gateway traffic of ``serve --mode
ingest``: sensors whose publish rates span about 2.5 decades.
"""
from __future__ import annotations

import dataclasses
import zlib as _zlib
from typing import Callable

import numpy as np

__all__ = ["DatasetSpec", "DATASETS", "load", "household_power", "ragged_sensor_traffic"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    decimals: int
    vmin: float
    vmax: float
    rows: int
    gen: Callable[[np.random.Generator, int], np.ndarray]


def _scale_to(v: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    lo, hi = float(v.min()), float(v.max())
    if hi <= lo:
        return np.full_like(v, (vmin + vmax) / 2)
    return vmin + (v - lo) * (vmax - vmin) / (hi - lo)


def _face_four(rng: np.random.Generator, n: int) -> np.ndarray:
    """UCR FaceFour: concatenated facial outlines — smooth quasi-periodic arcs."""
    t = np.arange(n)
    period = 350
    phase = 2 * np.pi * (t % period) / period
    shape_id = (t // period) % 4
    v = (
        np.sin(phase)
        + 0.45 * np.sin(2 * phase + shape_id * 0.7)
        + 0.2 * np.sin(5 * phase + shape_id)
        + 0.02 * rng.standard_normal(n)
    )
    return v


def _mote_strain(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sensor strain: noisy oscillation with drifting mean and bursts."""
    t = np.arange(n)
    drift = np.cumsum(rng.standard_normal(n)) * 0.003
    osc = np.sin(2 * np.pi * t / 84.0) * (1.0 + 0.5 * np.sin(2 * np.pi * t / 5000.0))
    bursts = (rng.random(n) < 0.001) * rng.standard_normal(n) * 4.0
    return osc + drift + bursts + 0.08 * rng.standard_normal(n)


def _lightning(rng: np.random.Generator, n: int) -> np.ndarray:
    """Mostly-flat signal with sharp exponential-decay strikes."""
    v = 0.03 * rng.standard_normal(n)
    n_strikes = max(4, n // 800)
    starts = rng.integers(0, n - 60, size=n_strikes)
    for s in starts:
        amp = rng.uniform(3.0, 20.0)
        decay = np.exp(-np.arange(50) / rng.uniform(3.0, 12.0)) * amp
        v[s : s + 50] += decay[: max(0, min(50, n - s))]
    return v


def _ecg(rng: np.random.Generator, n: int) -> np.ndarray:
    """Periodic PQRST-like waveform with beat-to-beat variability."""
    out = np.empty(n)
    i = 0
    while i < n:
        beat_len = int(rng.normal(140, 6))
        beat_len = max(100, min(180, beat_len))
        t = np.linspace(0, 1, beat_len)
        p = 0.18 * np.exp(-((t - 0.18) ** 2) / 0.0012)
        q = -0.28 * np.exp(-((t - 0.40) ** 2) / 0.0002)
        r = 1.0 * np.exp(-((t - 0.45) ** 2) / 0.0003) * rng.uniform(0.9, 1.1)
        s = -0.32 * np.exp(-((t - 0.50) ** 2) / 0.0002)
        tw = 0.30 * np.exp(-((t - 0.72) ** 2) / 0.0035)
        beat = p + q + r + s + tw
        m = min(beat_len, n - i)
        out[i : i + m] = beat[:m]
        i += m
    return out + 0.01 * rng.standard_normal(n)


def _cricket(rng: np.random.Generator, n: int) -> np.ndarray:
    """Wrist accelerometer: smooth segments + vigorous motion bursts."""
    t = np.arange(n)
    base = np.sin(2 * np.pi * t / 300.0) * 0.8
    k = max(1, n // 1200)
    env = np.zeros(n)
    starts = rng.integers(0, max(1, n - 400), size=k)
    for s in starts:
        ln = int(rng.uniform(150, 400))
        env[s : s + ln] += rng.uniform(1.5, 5.0)
    motion = env * np.sin(2 * np.pi * t / rng.uniform(20, 40)) * 0.8
    return base + motion + 0.05 * rng.standard_normal(n)


def _wind_direction(rng: np.random.Generator, n: int) -> np.ndarray:
    """Degrees 0..360, 2 decimals: slow meander + wrap-around jumps + plateaus."""
    steps = rng.standard_normal(n) * 0.8
    calm = rng.random(n) < 0.15
    steps[calm] = 0.0  # plateaus (instrument repeats identical readings)
    v = np.cumsum(steps) + 180.0
    v = np.mod(v, 360.0)
    return v


def _wafer(rng: np.random.Generator, n: int) -> np.ndarray:
    """Process-control traces: long flat plateaus + rapid transitions."""
    out = np.empty(n)
    levels = np.array([-0.9, 0.0, 1.0, 2.2, 4.0, 7.5, 10.5])
    i = 0
    cur = 0.0
    while i < n:
        ln = int(rng.uniform(40, 400))
        tgt = float(levels[rng.integers(0, len(levels))])
        ramp = min(12, ln)
        m = min(ln, n - i)
        seg = np.concatenate([np.linspace(cur, tgt, ramp), np.full(max(0, ln - ramp), tgt)])[:m]
        out[i : i + m] = seg
        cur = tgt
        i += m
    return out + 0.002 * rng.standard_normal(n)


def _ar1(e: np.ndarray, phi: float) -> np.ndarray:
    """x_t = sum_{k<=t} phi^(t-k) e_k via recursive doubling, O(n log n)."""
    x = e.copy()
    shift = 1
    while shift < len(x):
        factor = phi**shift
        if factor < 1e-14:
            break
        x[shift:] += factor * x[:-shift]
        shift *= 2
    return x


def _wind_speed(rng: np.random.Generator, n: int) -> np.ndarray:
    """m/s, 2 decimals: gusty, zero-clamped, sharp discontinuities."""
    v = _ar1(rng.standard_normal(n) * 0.25, 0.995) + 4.0
    jumps = (rng.random(n) < 0.0008) * rng.uniform(-4, 7, size=n)
    v = v + np.cumsum(jumps) * 0.05
    return np.abs(v)


def _pressure(rng: np.random.Generator, n: int) -> np.ndarray:
    """kPa, 5 decimals: smooth diurnal cycles + slow drift; highly repetitive."""
    t = np.arange(n)
    diurnal = 1.2 * np.sin(2 * np.pi * t / 14400.0) + 0.4 * np.sin(2 * np.pi * t / 7200.0 + 1.0)
    drift = np.cumsum(rng.standard_normal(n)) * 0.0008
    return 97.0 + diurnal + drift + 0.003 * rng.standard_normal(n)


def household_power(rng_seed: int, n: int, noise_sigma: float = 0.1) -> np.ndarray:
    """Fig. 10's scaling dataset: household power consumption analogue with
    sharp discontinuities (appliance switching) + N(0, 0.1) injected noise,
    mirroring the paper's synthetic-growth methodology."""
    rng = np.random.default_rng(rng_seed)
    out = np.empty(n)
    i = 0
    cur = 0.4
    while i < n:
        ln = int(rng.uniform(30, 600))
        if rng.random() < 0.35:
            cur = float(rng.choice([0.2, 0.4, 1.5, 2.4, 3.6, 5.0]))
        m = min(ln, n - i)
        out[i : i + m] = cur
        i += m
    out = out + rng.normal(0.0, noise_sigma, size=n)
    return np.round(out, 3)


def ragged_sensor_traffic(
    s: int,
    ticks: int,
    rate_lo: float = 2.0,
    rate_hi: float = 512.0,
    seed: int = 0,
) -> list[list[tuple[int, np.ndarray]]]:
    """Heterogeneous-rate gateway traffic: ``s`` sensors whose per-tick
    publish rates are drawn log-uniform over [rate_lo, rate_hi] (~2.5
    decades by default — the ragged regime of Sprintz, arXiv:1808.02515).
    Each tick, sensor ``sid`` emits ``Poisson(rate_sid)`` samples of its
    random walk (plus measurement noise, rounded to 4 decimals).

    Returns one list per tick of ``(sid, chunk)`` deliveries (sensors that
    drew zero samples omitted).  ``launch/serve.py --mode ingest`` drives
    it.
    """
    rng = np.random.default_rng(seed)
    rates = np.exp(rng.uniform(np.log(rate_lo), np.log(rate_hi), size=s))
    walks = np.zeros(s)
    out: list[list[tuple[int, np.ndarray]]] = []
    for _ in range(ticks):
        tick: list[tuple[int, np.ndarray]] = []
        for sid in range(s):
            n = int(rng.poisson(rates[sid]))
            if n == 0:
                continue
            chunk = walks[sid] + np.cumsum(rng.standard_normal(n) * 0.03)
            walks[sid] = chunk[-1]
            tick.append((sid, np.round(chunk + rng.standard_normal(n) * 0.01, 4)))
        out.append(tick)
    return out


_SPECS = [
    DatasetSpec("FaceFour", 8, -4.6, 5.9, 39_200, _face_four),
    DatasetSpec("MoteStrain", 8, -8.5, 8.5, 106_848, _mote_strain),
    DatasetSpec("Lightning", 8, -1.6, 23.1, 122_694, _lightning),
    DatasetSpec("ECG", 11, -7.0, 7.4, 699_720, _ecg),
    DatasetSpec("Cricket", 8, -10.1, 12.7, 702_000, _cricket),
    DatasetSpec("WindDirection", 2, 0.0, 360.0, 1_169_510, _wind_direction),
    DatasetSpec("Wafer", 7, -3.0, 12.1, 1_088_928, _wafer),
    DatasetSpec("WindSpeed", 2, 0.0, 20.4, 4_119_081, _wind_speed),
    DatasetSpec("Pressure", 5, 90.9, 104.1, 12_098_677, _pressure),
]

DATASETS: dict[str, DatasetSpec] = {s.name: s for s in _SPECS}


def load(name: str, n: int | None = None, seed: int = 1234) -> np.ndarray:
    """Generate dataset `name` with `n` rows (default: full Table II size)."""
    spec = DATASETS[name]
    rows = spec.rows if n is None else int(n)
    rng = np.random.default_rng(seed + _zlib.crc32(name.encode()) % 100_000)
    v = spec.gen(rng, rows)
    v = _scale_to(v, spec.vmin, spec.vmax)
    return np.round(v, spec.decimals)
