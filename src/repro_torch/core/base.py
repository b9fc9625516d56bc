"""Knowledge-base construction (Alg. 4), counterpart of ``repro.core.base``.

Cones are grouped by their quantized origin (level and grid index), sorted
inside each group by ascending span, and greedily merged while the spans
intersect; each merged sub-base gets the shortest-decimal slope of its
span.  This is per-segment bookkeeping and stays on the host.  The base
predictions ``theta + slope * (t - t0)`` for every sample are torch ops on
the device, kept as a separate multiply and add so they match numpy bit
for bit.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from .device import resolve_device
from .phases import eps_hat_for_level
from .slope import optimized_slope
from .types import Base, Segment, ShrinkConfig, SubBase

__all__ = [
    "base_predictions",
    "base_predictions_batch",
    "base_predictions_ragged",
    "construct_base",
    "origin_index",
    "practical_eps_b",
]


def origin_index(theta: float, level: int, config: ShrinkConfig) -> int:
    """Grid index of a quantized origin: theta == idx * eps_hat(level)."""
    return int(round(theta / eps_hat_for_level(level, config)))


def construct_base(
    segments: list[Segment],
    n: int,
    vmin: float,
    vmax: float,
    config: ShrinkConfig,
) -> Base:
    """Alg. 4: group by origin, sort by psi_lo, greedy merge intersections."""
    groups: dict[tuple[int, int], list[Segment]] = defaultdict(list)
    for seg in segments:
        groups[(seg.level, origin_index(seg.theta, seg.level, config))].append(seg)

    subbases: list[SubBase] = []

    def flush(level: int, lo: float, hi: float, members: list[Segment]) -> None:
        slope, digits = optimized_slope(lo, hi)
        t0s = np.array([m.t0 for m in members], dtype=np.int64)
        order = np.argsort(t0s)
        lengths = np.array([m.length for m in members], dtype=np.int64)[order]
        subbases.append(
            SubBase(
                theta=members[0].theta,
                level=level,
                psi_lo=lo,
                psi_hi=hi,
                slope=slope,
                slope_digits=digits,
                t0s=t0s[order],
                lengths=lengths,
            )
        )

    for key in sorted(groups.keys()):
        level = key[0]
        cur_lo, cur_hi = -math.inf, math.inf
        members: list[Segment] = []
        for seg in sorted(groups[key], key=lambda s: (s.psi_lo, s.psi_hi)):
            new_lo = max(cur_lo, seg.psi_lo)
            new_hi = min(cur_hi, seg.psi_hi)
            if not members or new_lo <= new_hi:
                cur_lo, cur_hi = new_lo, new_hi
                members.append(seg)
            else:
                flush(level, cur_lo, cur_hi, members)
                cur_lo, cur_hi, members = seg.psi_lo, seg.psi_hi, [seg]
        if members:
            flush(level, cur_lo, cur_hi, members)

    # deterministic order: by first timestamp (helps delta-coding timestamps)
    subbases.sort(key=lambda sb: int(sb.t0s[0]))
    return Base(n=n, config=config, vmin=vmin, vmax=vmax, subbases=subbases)


def _flat_segments(base: Base) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All member segments sorted by t0: (t0s, lengths, thetas, slopes)."""
    sbs = base.subbases
    if not sbs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.float64), z.astype(np.float64)
    t0s = np.concatenate([sb.t0s for sb in sbs])
    lens = np.concatenate([sb.lengths for sb in sbs])
    thetas = np.concatenate([np.full(len(sb.t0s), sb.theta) for sb in sbs])
    slopes = np.concatenate([np.full(len(sb.t0s), sb.slope) for sb in sbs])
    order = np.argsort(t0s, kind="stable")  # t0s are unique: a partition
    return t0s[order], lens[order], thetas[order], slopes[order]


def base_predictions_batch(bases: list[Base], device: torch.device | str) -> torch.Tensor:
    """[S, n] float64 base predictions of bases that share one length n."""
    s = len(bases)
    n = bases[0].n if s else 0
    if s == 0 or n == 0:
        return torch.zeros((s, n), dtype=torch.float64, device=device)
    flats = [_flat_segments(b) for b in bases]

    def cat(i: int) -> torch.Tensor:
        return torch.from_numpy(np.concatenate([f[i] for f in flats])).to(device)

    lens = cat(1)
    total = s * n
    theta = torch.repeat_interleave(cat(2), lens, output_size=total)
    slope = torch.repeat_interleave(cat(3), lens, output_size=total)
    start = torch.repeat_interleave(cat(0).to(torch.float64), lens, output_size=total)
    t = torch.arange(n, dtype=torch.float64, device=device).repeat(s)
    return (theta + slope * (t - start)).view(s, n)


def base_predictions_ragged(
    bases: list[Base], pad_to: int, device: torch.device | str
) -> torch.Tensor:
    """[S, pad_to] float64: row i holds the base predictions of
    ``bases[i]`` (any mix of lengths) in its first ``bases[i].n`` slots
    and 0.0 beyond."""
    s = len(bases)
    out = torch.zeros((s, pad_to), dtype=torch.float64, device=device)
    ns = [b.n for b in bases]
    if max(ns, default=0) > pad_to:
        raise ValueError(f"pad_to={pad_to} smaller than longest base n={max(ns)}")
    total = sum(ns)
    if total == 0:
        return out
    flats = [_flat_segments(b) for b in bases]

    def cat(i: int) -> torch.Tensor:
        return torch.from_numpy(np.concatenate([f[i] for f in flats])).to(device)

    lens = cat(1)
    theta = torch.repeat_interleave(cat(2), lens, output_size=total)
    slope = torch.repeat_interleave(cat(3), lens, output_size=total)
    start = torch.repeat_interleave(cat(0).to(torch.float64), lens, output_size=total)
    n_t = torch.tensor(ns, dtype=torch.int64, device=device)
    series_of = torch.repeat_interleave(torch.arange(s, device=device), n_t, output_size=total)
    first = torch.repeat_interleave(torch.cumsum(n_t, 0) - n_t, n_t, output_size=total)
    t_local = torch.arange(total, device=device) - first
    out[series_of, t_local] = theta + slope * (t_local.to(torch.float64) - start)
    return out


def base_predictions(base: Base, device: torch.device | str | None = None) -> torch.Tensor:
    """The base-only approximation of one series: n float64 values on
    ``device`` (default the card)."""
    return base_predictions_batch([base], resolve_device(device))[0]


def practical_eps_b(values: torch.Tensor, base: Base, pred: torch.Tensor | None = None) -> float:
    """The paper's \\hat{eps}_b: realized max |v - base prediction|."""
    if base.n == 0:
        return 0.0
    if pred is None:
        pred = base_predictions(base, values.device)
    return float((values - pred).abs().max())
